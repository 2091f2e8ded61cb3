"""The port's closed train->eval capability loop against the JAX package, on the CPU.

`script/run_capability_loop.py` at the scale of JAX's
`tests/test_capability_loop.py::test_capability_loop_mini` (16 frames a
log, batches of 4, 2 epochs; 6 held-out tokens) with `device="cpu"`: every
stage runs (fleet, features, `Trainer.fit` and its one checkpoint, metric
caching with PDM-Closed, scoring of the untrained, trained and human-replay
agents) and gives finite PDMS, human replay above 0.75. Against JAX: the
same `_tiny_config` field for field, the same fleet, tokens and
train/held-out split, `_token_batches` equal array for array, and the
human-replay rows of the port's runner (as the loop ran it) within 1e-4 of
JAX's `run_pdm_score_evaluation` on the same held-out caches (the port's,
read by JAX's loader).
"""

import json

import numpy as np
import pytest

from diffusiondrive_torch.script import run_capability_loop as pcap
from diffusiondrive_tpu.script import run_capability_loop as jcap

from test_torch_port_model import _port_config
from test_torch_port_score import _rows_equal

MINI = dict(num_frames=16, batch_size=4, num_epochs=2)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """(output directory, results, each scoring run's rows in order: untrained, trained, human replay)."""
    out = tmp_path_factory.mktemp("capability") / "cap"
    scored = []

    def mean_pdms(rows):
        scored.append(rows)
        return mean(rows)

    mean = pcap._mean_pdms
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pcap, "_mean_pdms", mean_pdms)
        results = pcap.run_capability_loop(out, **MINI, eval_human=True, device="cpu")
    return out, results, scored


def test_tiny_config_is_jaxs_field_for_field():
    assert pcap._tiny_config() == _port_config(jcap._tiny_config())
    assert (pcap.TRAIN_SPEEDS, pcap.HOLDOUT_SPEEDS) == (jcap.TRAIN_SPEEDS, jcap.HOLDOUT_SPEEDS)


def test_capability_loop_mini_runs_every_stage(loop):
    out, results, _ = loop
    for key in ("untrained_pdms", "trained_pdms", "human_replay_pdms", "margin"):
        assert np.isfinite(results[key]), key
    assert 0.0 <= results["untrained_pdms"] <= 1.0 and 0.0 <= results["trained_pdms"] <= 1.0
    # human replay of a clean constant-speed drive on an empty straight road scores high
    assert results["human_replay_pdms"] > 0.75, results
    assert results["ok"] == (results["margin"] > 0.1)
    on_disk = json.loads((out / "capability_loop.json").read_text())
    assert on_disk["num_holdout_tokens"] == 6 and on_disk["num_train_tokens"] == 12
    assert (on_disk["num_epochs"], on_disk["steps_per_epoch"]) == (2, 3)
    assert (out / "train" / "epoch_0001" / "state.pt").exists()
    assert set(on_disk["stage_s"]) == {"fleet", "features", "train", "cache", "evaluate_untrained",
                                       "evaluate_trained", "evaluate_human"}
    # on the CPU no kernel launches
    assert all(not v for v in on_disk["launches"].values())


def _loaders(root, tokens=None):
    """The port's and JAX's scene loaders over one fleet, with the agent's sensors."""
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.common.dataclasses import SceneFilter
    from diffusiondrive_torch.common.dataloader import SceneLoader
    from diffusiondrive_tpu.agents.diffusiondrive.agent import DiffusionDriveAgent as JAgent
    from diffusiondrive_tpu.common.dataclasses import SceneFilter as JSceneFilter
    from diffusiondrive_tpu.common.dataloader import SceneLoader as JSceneLoader

    sensors = DiffusionDriveAgent(config=pcap._tiny_config(), device="cpu").get_sensor_config()
    jsensors = JAgent(config=jcap._tiny_config()).get_sensor_config()
    return (SceneLoader(root / "logs", root / "blobs", SceneFilter(frame_interval=1, tokens=tokens), sensors,
                        build_map_api=False),
            JSceneLoader(root / "logs", root / "blobs", JSceneFilter(frame_interval=1, tokens=tokens), jsensors,
                         build_map_api=False))


def test_fleet_tokens_and_split_equal_jax(loop, tmp_path):
    out, _, _ = loop
    jcap.build_speed_fleet(tmp_path / "jax", MINI["num_frames"])
    loader, _ = _loaders(out / "data")
    _, jloader = _loaders(tmp_path / "jax")
    per_log, jper_log = loader.get_tokens_list_per_log(), jloader.get_tokens_list_per_log()
    assert per_log == jper_log
    assert sorted(per_log) == [f"speed_{s:.0f}" for s in sorted((*jcap.TRAIN_SPEEDS, *jcap.HOLDOUT_SPEEDS))]
    assert all(len(t) == 3 for t in per_log.values())
    for sub in ("logs", "blobs/cams", "blobs/lidar"):
        files = sorted(p.name for p in (out / "data" / sub).iterdir())
        assert files == sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        if sub != "logs":   # the sensor blobs byte for byte (the log pickles name each package's classes)
            for name in files:
                assert (out / "data" / sub / name).read_bytes() == (tmp_path / "jax" / sub / name).read_bytes(), name


def test_token_batches_equal_jax(loop):
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.utils.synthetic import make_straight_map
    from diffusiondrive_tpu.agents.diffusiondrive.agent import DiffusionDriveAgent as JAgent
    from diffusiondrive_tpu.utils.synthetic import make_straight_map as jmake_straight_map

    out, _, _ = loop
    loader, jloader = _loaders(out / "data")
    holdout = {f"speed_{s:.0f}" for s in pcap.HOLDOUT_SPEEDS}
    tokens = [t for log, toks in loader.get_tokens_list_per_log().items() if log not in holdout for t in toks]
    got = pcap._token_batches(loader, tokens, make_straight_map(),
                              DiffusionDriveAgent(config=pcap._tiny_config(), device="cpu"), MINI["batch_size"])
    want = jcap._token_batches(jloader, tokens, jmake_straight_map(), JAgent(config=jcap._tiny_config()),
                               MINI["batch_size"])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_human_replay_rows_equal_jax_runner(loop):
    from diffusiondrive_tpu.agents.human_agent import HumanAgent as JHumanAgent
    from diffusiondrive_tpu.common.dataloader import MetricCacheLoader as JMetricCacheLoader
    from diffusiondrive_tpu.evaluate.runner import run_pdm_score_evaluation as jax_run

    out, results, scored = loop
    assert len(scored) == 3   # untrained, trained, human replay
    rows = scored[2]   # the port's runner, as the loop ran it
    holdout = {f"speed_{s:.0f}" for s in pcap.HOLDOUT_SPEEDS}
    per_log = _loaders(out / "data")[0].get_tokens_list_per_log()
    tokens = [t for log, toks in per_log.items() if log in holdout for t in toks]
    _, jloader = _loaders(out / "data", tokens)
    jrows = jax_run(JHumanAgent(), jloader, JMetricCacheLoader(out / "metric_cache"), batch_size=MINI["batch_size"])
    assert len(rows) == 6 and all(r["valid"] for r in rows)
    _rows_equal(rows, jrows)
    assert abs(np.mean([r["score"] for r in rows]) - results["human_replay_pdms"]) <= 1e-6
