"""Parity of the port's entry points with the JAX package, on the CPU.

Config composition (`config/compose.py`) on every case of
`tests/test_config_compose.py` and the repo's top-level configs: the same
dict, the same error class and message, a byte-equal `config.yaml`
snapshot. The registry: JAX's agent names, the model variants built as
JAX's registry builds them (head and config) with a finite CPU forward,
the YAML dtype, the orbax refusal, the splits. The
EgoStatusMLP agent: its forward within 1e-5 on JAX's converted params,
`training/generic.py`'s losses and parameters within 1e-5 relative of
JAX's generic step over 20 Adam steps on the same batches (the two
optimizers apply one formula in another order), and JAX's "learns the
4 m/s drive" test on the port. The CLIs on `synthetic_log` with `--device
cpu` against the JAX CLIs: score CSVs, metric caches, feature caches and
submission predictions (constant-velocity agent; the JAX CLI tests run no
other); a JAX-written submission read in a fresh interpreter without the
JAX package; each CLI raising without a card unless `--device cpu`.
"""

import csv
import dataclasses
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import diffusiondrive_torch.config.compose as pcompose
import diffusiondrive_tpu.config.compose as jcompose
from diffusiondrive_torch.config import registry as preg
from diffusiondrive_tpu.config import registry as jreg

from test_runner import build_caches
from test_torch_port_model import _port_config
from test_train import tiny_config

REPO = Path(__file__).resolve().parents[1]
TOP_CONFIGS = ("common", "default_dataset_caching", "default_evaluation", "default_metric_caching",
               "default_submission", "default_training")


# --------------------------------------------------------------------------- #
# config composition
# --------------------------------------------------------------------------- #

def _config_tree(root: Path) -> Path:
    """The tree of `tests/test_config_compose.py:config_tree`."""
    (root / "agent").mkdir(parents=True)
    (root / "worker").mkdir()
    (root / "base.yaml").write_text("output_dir: /tmp/exp\nseed: 1\n")
    (root / "agent" / "cv.yaml").write_text("name: constant_velocity_agent\n")
    (root / "agent" / "dd.yaml").write_text("name: diffusiondrive_agent\nconfig:\n  tf_d_model: 256\n")
    (root / "worker" / "seq.yaml").write_text("name: sequential\n")
    (root / "main.yaml").write_text("defaults:\n  - base\n  - agent: cv\n  - worker: seq\n  - _self_\n"
                                    "batch_size: 32\ncache_dir: ${output_dir}/cache\nseed: 7\n")
    (root / "env.yaml").write_text("a: ${oc.env:DD_TEST_VAR}\nb: ${oc.env:DD_TEST_MISSING,fallback}\n"
                                   "c: prefix-${env:DD_TEST_VAR}-suffix\nd: ${oc.env:DD_TEST_MISSING,123}\n")
    (root / "missing_env.yaml").write_text("a: ${oc.env:DD_DEFINITELY_MISSING}\n")
    (root / "cycle.yaml").write_text("a: ${b}\nb: ${a}\n")
    (root / "typed.yaml").write_text("count: 4\nalias: ${count}\nnested:\n  inner: ${count}\n")
    return root


COMPOSE_CASES = {
    "defaults_and_self": lambda m, t: m.compose(t / "main.yaml"),
    "group_override": lambda m, t: m.compose(t / "main.yaml", ["agent=dd", "batch_size=64"]),
    "dotted_overrides": lambda m, t: m.compose(t / "main.yaml", ["agent.config.tf_d_model=128",
                                                                  "agent.checkpoint_path=/x.pth"]),
    "yaml_typed_overrides": lambda m, t: m.compose(t / "main.yaml", ["batch_size=null", "seed=1.5", "lr=1e-3"]),
    "env_interpolation": lambda m, t: m.compose(t / "env.yaml"),
    "missing_env_raises": lambda m, t: m.compose(t / "missing_env.yaml"),
    "interpolation_cycle_raises": lambda m, t: m.compose(t / "cycle.yaml"),
    "full_string_interp_keeps_type": lambda m, t: m.compose(t / "typed.yaml"),
    "snapshot_roundtrip": lambda m, t: m.compose(m.snapshot(m.compose(t / "main.yaml", ["agent=dd"]), t / "snap")),
    "apply_overrides": lambda m, t: m.apply_overrides({"a": {"b": 1}}, ["a.b=2", "a.c=x", "d=true"]),
    "apply_overrides_no_equals_raises": lambda m, t: m.apply_overrides({}, ["no_equals"]),
    "config_get": lambda m, t: [m.config_get({"a": {"b": 5}}, "a.b"), m.config_get({"a": {"b": 5}}, "a.z", "d")],
    "load_config_unresolved": lambda m, t: m.load_config(t / "main.yaml"),
    "missing_file_raises": lambda m, t: m.compose(t / "nope.yaml"),
    "vendored_evaluation_overrides": lambda m, t: m.compose("default_evaluation",
                                                            ["agent=diffusiondrive_agent", "split=navmini"]),
    "vendored_training_ego_mlp": lambda m, t: m.compose("default_training", ["agent=ego_status_mlp_agent", "lr=1e-3"]),
    **{f"vendored_{name}": (lambda name: lambda m, t: m.compose(name))(name) for name in TOP_CONFIGS},
}


def _outcome(fn, module, root):
    try:
        return "ok", fn(module, root)
    except Exception as exc:  # noqa: BLE001 — the error itself is compared
        return type(exc).__name__, str(exc).replace(str(Path(module.__file__).parents[1]), "<pkg>")


@pytest.mark.parametrize("case", sorted(COMPOSE_CASES))
def test_compose_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv("DD_TEST_VAR", "hello")
    monkeypatch.setenv("NAVSIM_EXP_ROOT", "/e")
    monkeypatch.delenv("DD_TEST_MISSING", raising=False)
    monkeypatch.delenv("DD_DEFINITELY_MISSING", raising=False)
    fn = COMPOSE_CASES[case]
    got = _outcome(fn, pcompose, _config_tree(tmp_path / "port"))
    want = _outcome(fn, jcompose, _config_tree(tmp_path / "jax"))
    if got[0] == "ok":
        got = ("ok", yaml.safe_load(yaml.safe_dump(got[1]).replace(str(tmp_path / "port"), "<tree>")))
        want = ("ok", yaml.safe_load(yaml.safe_dump(want[1]).replace(str(tmp_path / "jax"), "<tree>")))
    else:
        got = (got[0], got[1].replace(str(tmp_path / "port"), "<tree>"))
        want = (want[0], want[1].replace(str(tmp_path / "jax"), "<tree>"))
    assert got == want
    if got[0] != "ok" and got[0] == "ConfigError":
        assert issubclass(pcompose.ConfigError, ValueError)
    if got[0] == "ok" and isinstance(got[1], dict):
        snaps = [m.snapshot(got[1], tmp_path / f"snap_{m.__name__}") for m in (pcompose, jcompose)]
        assert snaps[0].read_bytes() == snaps[1].read_bytes()


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #

TINY_AGENT = {k: getattr(tiny_config(), k) for k in (
    "image_architecture", "lidar_architecture", "camera_height", "camera_width", "lidar_resolution_height",
    "lidar_resolution_width", "img_vert_anchors", "img_horz_anchors", "lidar_vert_anchors",
    "lidar_horz_anchors", "bev_pixel_height", "bev_pixel_width")}


def test_registry_names_and_the_agents_it_builds(tmp_path):
    from diffusiondrive_torch.agents.constant_velocity_agent import ConstantVelocityAgent
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.agents.ego_status_mlp_agent import EgoStatusMLPAgent

    assert preg.available_agents() == jreg.available_agents()
    # the model variants build as JAX's registry builds them (head, config) and run on the CPU
    rng = np.random.default_rng(0)
    for name, head in (("transfuser_agent", "mlp"), ("diffusion_policy_agent", "unet"),
                       ("diffusiondrive_nuscenes_agent", "diffusion")):
        cfg = dict(TINY_AGENT, **({"image_architecture": "resnet50", "lidar_architecture": "resnet50"}
                                  if name == "diffusiondrive_nuscenes_agent" else {}))
        jagent = jreg.agent_from_config({"name": name, "config": dict(cfg)})
        agent = preg.agent_from_config({"name": name, "dtype": "float32", "config": dict(cfg)}, device="cpu")
        assert isinstance(agent, DiffusionDriveAgent) and agent.trajectory_head_type == head
        assert jagent.model.trajectory_head_type == head
        jts, pts = jagent.config.trajectory_sampling, agent.config.trajectory_sampling
        assert agent.config == dataclasses.replace(_port_config(jagent.config), trajectory_sampling=pts)
        assert (pts.num_poses, pts.interval_length) == (jts.num_poses, jts.interval_length)
        c = agent.config
        features = {"camera_feature": rng.integers(0, 256, (2, c.camera_height, c.camera_width, 3), dtype=np.uint8),
                    "lidar_feature": rng.uniform(size=(2, c.lidar_resolution_height, c.lidar_resolution_width,
                                                       1)).astype(np.float32),
                    "status_feature": rng.normal(size=(2, 8)).astype(np.float32)}
        traj = agent.forward(features)["trajectory"]
        assert traj.shape == (2, pts.num_poses, 3) and np.isfinite(traj).all()
    assert preg.agent_from_config({"name": "diffusiondrive_nuscenes_agent", "config": {}},
                                  device="cpu").config.num_poses == 6
    unet = preg.build_agent("diffusiondrive_agent", trajectory_head_type="unet", device="cpu")
    assert unet.trajectory_head_type == "unet" and unet.config == _port_config(jreg.build_agent(
        "diffusiondrive_agent", trajectory_head_type="unet").config)
    with pytest.raises(KeyError):
        preg.build_agent("no_such_agent")
    assert isinstance(preg.agent_from_config({"name": "constant_velocity_agent"}, device="cpu"),
                      ConstantVelocityAgent)
    agent = preg.agent_from_config({"name": "diffusiondrive_agent", "dtype": "float32", "config": TINY_AGENT,
                                    "preprocess_on_device": True}, device="cpu")
    assert isinstance(agent, DiffusionDriveAgent) and agent._dtype == torch.float32
    assert agent.config == _port_config(tiny_config()) and agent.device == torch.device("cpu")
    vanilla = preg.agent_from_config({"name": "diffusiondrive_vanilla_ddim_agent", "config": {}}, device="cpu")
    assert vanilla.config.diffusion_test_steps == 20 and vanilla._dtype == torch.bfloat16
    mlp = preg.agent_from_config(preg.load_yaml(REPO / "configs" / "agent" / "ego_status_mlp_agent.yaml"),
                                 device="cpu")
    assert isinstance(mlp, EgoStatusMLPAgent) and mlp._hidden_layer_dim == 512
    (tmp_path / "orbax_ckpt" / "default").mkdir(parents=True)   # a directory without state.pt
    for name in ("diffusiondrive_agent", "ego_status_mlp_agent"):
        with pytest.raises(ValueError, match="port_jax.py"):
            preg.build_agent(name, checkpoint_path=str(tmp_path / "orbax_ckpt"), device="cpu")
    if not torch.cuda.is_available():   # the card by default: no silent CPU path
        for name in ("diffusiondrive_agent", "ego_status_mlp_agent"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                preg.build_agent(name)


def test_splits_load_as_in_jax():
    """Every split of `splits/` by name (but navtrain's 2 MB of YAML), one by path."""
    for path in sorted((REPO / "splits").glob("*.yaml")):
        if path.stem != "navtrain":
            split = preg.load_split(path.stem)
            assert split == jreg.load_split(path.stem)
            assert vars(preg.scene_filter_from_split(split)) == vars(jreg.scene_filter_from_split(split))
    path = str(REPO / "splits" / "navmini_example.yaml")
    assert preg.load_split(path) == jreg.load_split(path) and preg.load_split(None) == jreg.load_split(None)


# --------------------------------------------------------------------------- #
# the EgoStatusMLP agent and the generic training loop
# --------------------------------------------------------------------------- #

def _mlp_pair(hidden=64, lr=1e-3):
    from diffusiondrive_tpu.agents.ego_status_mlp_agent import EgoStatusMLPAgent as JAgent

    from diffusiondrive_torch.agents.ego_status_mlp_agent import EgoStatusMLPAgent
    from diffusiondrive_torch.utils.port_jax import load_jax_variables

    jagent = JAgent(hidden_layer_dim=hidden, lr=lr)
    jagent.initialize()
    agent = EgoStatusMLPAgent(hidden_layer_dim=hidden, lr=lr, device="cpu")
    agent.initialize()
    load_jax_variables(agent.model, jagent.variables)
    return agent, jagent


def test_ego_mlp_forward_and_generic_steps_match_jax():
    import jax

    from diffusiondrive_tpu.training.generic import make_generic_train_step as j_step

    from diffusiondrive_torch.training.generic import make_generic_train_step

    agent, jagent = _mlp_pair()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (16, 8)).astype(np.float32)
    np.testing.assert_allclose(agent.forward({"ego_status": x})["trajectory"],
                               jagent.forward({"ego_status": x})["trajectory"], rtol=1e-5, atol=1e-5)

    batches = [{"ego_status": rng.normal(0, 3, (4, 8)).astype(np.float32),
                "trajectory": rng.normal(0, 5, (4, 8, 3)).astype(np.float32)} for _ in range(20)]
    step = make_generic_train_step(agent.model, agent.compute_loss, agent.get_optimizers(), ("ego_status",),
                                   agent.device)
    jstep = j_step(jagent.model, jagent.compute_loss, jagent.get_optimizers(), ("ego_status",))
    params, opt_state = jagent.variables, jagent.get_optimizers().init(jagent.variables)
    for i, batch in enumerate(batches):
        loss = float(step(batch))
        params, opt_state, jloss = jstep(params, opt_state, batch)
        assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss)), (i, loss, float(jloss))
    want = {k: np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(params["params"])[0] for k, v in
            [(".".join(p.key for p in k).replace("kernel", "weight"), v)]}
    for name, p in agent.model.named_parameters():
        w = want[name].T if name.endswith("weight") else want[name]
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)


def test_ego_mlp_learns_constant_velocity(synthetic_log, tmp_path):
    """`tests/test_generic_training.py` on the port."""
    from diffusiondrive_torch.agents.ego_status_mlp_agent import (
        EgoStatusFeatureBuilder, EgoStatusMLPAgent, TrajectoryTargetBuilder)
    from diffusiondrive_torch.common.dataclasses import SceneFilter, SensorConfig, TrajectorySampling
    from diffusiondrive_torch.common.dataloader import SceneLoader
    from diffusiondrive_torch.training.dataset import Dataset
    from diffusiondrive_torch.training.generic import train_agent

    logs_dir, blobs_dir = synthetic_log
    loader = SceneLoader(logs_dir, blobs_dir, SceneFilter(num_history_frames=4, num_future_frames=10,
                                                          frame_interval=1),
                         SensorConfig.build_no_sensors(), build_map_api=False)
    dataset = Dataset(loader, [EgoStatusFeatureBuilder()],
                      [TrajectoryTargetBuilder(TrajectorySampling(time_horizon=4, interval_length=0.5))],
                      cache_path=str(tmp_path / "cache"))
    agent = EgoStatusMLPAgent(hidden_layer_dim=64, lr=1e-3, device="cpu")
    agent.initialize()
    model = agent.model
    before = agent.compute_trajectory(loader.get_agent_input_from_token(loader.tokens[0]))
    err_before = np.abs(before.poses[:, 0] - 2.0 * np.arange(1, 9)).mean()
    train_agent(agent, dataset, batch_size=2, num_epochs=300)
    after = agent.compute_trajectory(loader.get_agent_input_from_token(loader.tokens[0]))
    err_after = np.abs(after.poses[:, 0] - 2.0 * np.arange(1, 9)).mean()
    assert agent.model is model   # initialize is idempotent
    assert err_after < err_before
    assert err_after < 0.5, err_after   # learned the 4 m/s straight drive
    agent.save_checkpoint(tmp_path / "mlp.pt")
    again = EgoStatusMLPAgent(hidden_layer_dim=64, checkpoint_path=str(tmp_path / "mlp.pt"), device="cpu")
    np.testing.assert_array_equal(again.compute_trajectory(loader.get_agent_input_from_token(loader.tokens[0])).poses,
                                  after.poses)


# --------------------------------------------------------------------------- #
# the CLIs against the JAX CLIs
# --------------------------------------------------------------------------- #

def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    module.main()


def _read_csv(path):
    with open(path, newline="") as fp:
        return list(csv.reader(fp))


def _one_csv(out_dir):
    (path,) = sorted(Path(out_dir).glob("*.csv"))
    return _read_csv(path)


def _assert_csv_equal(got, want, tol=1e-5):
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3], (g, w)
        for a, b in zip(g[3:], w[3:]):
            assert (a == b == "") or abs(float(a) - float(b)) <= tol, (g, w)


@pytest.fixture(scope="module")
def cli_inputs(synthetic_log, tmp_path_factory):
    from diffusiondrive_torch.common.dataclasses import SceneFilter
    from diffusiondrive_torch.common.dataloader import SceneLoader

    logs_dir, blobs_dir = synthetic_log
    root = tmp_path_factory.mktemp("cli")
    tokens = SceneLoader(logs_dir, blobs_dir, SceneFilter(frame_interval=1), build_map_api=False).tokens
    build_caches(tokens, root / "metric_cache")
    split = root / "split.yaml"
    split.write_text(yaml.safe_dump({"frame_interval": 1}))
    agent_cfg = root / "agent.yaml"
    agent_cfg.write_text(yaml.safe_dump({"config": {**TINY_AGENT, "pixels_per_meter": 1.0}}))
    return dict(logs=str(logs_dir), blobs=str(blobs_dir), root=root, tokens=tokens, split=str(split),
                cache=str(root / "metric_cache"), agent_cfg=str(agent_cfg))


def test_pdm_score_and_submission_clis_match_jax(cli_inputs, tmp_path, monkeypatch):
    """run_pdm_score, run_create_submission_pickle, run_merge_submission_pickles
    and run_pdm_score_from_submission (CV agent) against the JAX CLIs; the
    port reads the JAX-written pickles, and its submission-scored CSV
    equals its run_pdm_score CSV."""
    import diffusiondrive_tpu.script.run_create_submission_pickle as j_create
    import diffusiondrive_tpu.script.run_merge_submission_pickles as j_merge
    import diffusiondrive_tpu.script.run_pdm_score as j_score
    import diffusiondrive_tpu.script.run_pdm_score_from_submission as j_from_sub

    from diffusiondrive_torch.script import (run_create_submission_pickle, run_merge_submission_pickles,
                                             run_pdm_score, run_pdm_score_from_submission)

    c = cli_inputs
    n = len(c["tokens"])
    common = ["--agent", "constant_velocity_agent", "--navsim-log-path", c["logs"],
              "--sensor-blobs-path", c["blobs"], "--split", c["split"]]
    score_args = common + ["--metric-cache-path", c["cache"], "--batch-size", str(n)]
    run_pdm_score.main(score_args + ["--output-dir", str(tmp_path / "p_score"), "--device", "cpu"])
    _jax_main(j_score, score_args + ["--output-dir", str(tmp_path / "j_score")], monkeypatch)
    direct = _one_csv(tmp_path / "p_score")
    _assert_csv_equal(direct, _one_csv(tmp_path / "j_score"))
    assert len(direct) == n + 2 and all(r[2] == "True" for r in direct[1:])
    # --mesh-devices over the CPU's one device gives JAX's --mesh-devices 1
    # CSV; more devices than there are raises JAX's range message
    _jax_main(j_score, score_args + ["--output-dir", str(tmp_path / "j_mesh"), "--mesh-devices", "1"], monkeypatch)
    for mesh in ("1", "-1"):
        run_pdm_score.main(score_args + ["--output-dir", str(tmp_path / f"mesh{mesh}"), "--device", "cpu",
                                         "--mesh-devices", mesh])
        _assert_csv_equal(_one_csv(tmp_path / f"mesh{mesh}"), _one_csv(tmp_path / "j_mesh"))
    with pytest.raises(SystemExit, match=r"--mesh-devices must be 0 \(no mesh\), -1 \(all\) or 1\.\.1 "
                                         r"\(have 1 devices\), got 2"):
        run_pdm_score.main(score_args + ["--output-dir", str(tmp_path / "mesh"), "--device", "cpu",
                                         "--mesh-devices", "2"])

    team = ["--team-name", "t", "--authors", "a", "--email", "e", "--institution", "i", "--country", "c"]
    run_create_submission_pickle.main(common + team + ["--output-dir", str(tmp_path / "p_sub"), "--device", "cpu"])
    _jax_main(j_create, common + team + ["--output-dir", str(tmp_path / "j_sub")], monkeypatch)
    with open(tmp_path / "p_sub" / "submission.pkl", "rb") as fp:
        got = pickle.load(fp)
    with open(tmp_path / "j_sub" / "submission.pkl", "rb") as fp:
        want = pickle.load(fp)
    assert {k: v for k, v in got.items() if k != "predictions"} == {k: v for k, v in want.items() if k != "predictions"}
    assert sorted(got["predictions"][0]) == sorted(want["predictions"][0]) == sorted(c["tokens"])
    for tok, traj in want["predictions"][0].items():
        np.testing.assert_array_equal(got["predictions"][0][tok].poses, traj.poses)
        assert vars(got["predictions"][0][tok].trajectory_sampling) == vars(traj.trajectory_sampling)

    # the JAX submission split in two, merged by both packages
    halves = []
    for i, part in enumerate((c["tokens"][:1], c["tokens"][1:])):
        halves.append(str(tmp_path / f"half_{i}.pkl"))
        with open(halves[-1], "wb") as fp:
            pickle.dump({**want, "predictions": [{t: want["predictions"][0][t] for t in part}]}, fp)
    run_merge_submission_pickles.main([*halves, "--output", str(tmp_path / "p_merged.pkl")])
    _jax_main(j_merge, [*halves, "--output", str(tmp_path / "j_merged.pkl")], monkeypatch)
    from diffusiondrive_torch.script.cli_common import load_submission

    merged, jmerged = load_submission(tmp_path / "p_merged.pkl"), load_submission(tmp_path / "j_merged.pkl")
    assert sorted(merged["predictions"][0]) == sorted(jmerged["predictions"][0]) == sorted(c["tokens"])
    assert type(merged["predictions"][0][c["tokens"][0]]).__module__ == "diffusiondrive_torch.common.dataclasses"

    from_sub = ["--metric-cache-path", c["cache"], "--batch-size", str(n)]
    run_pdm_score_from_submission.main(["--submission", str(tmp_path / "j_merged.pkl"), *from_sub,
                                        "--output-dir", str(tmp_path / "p_from_sub"), "--device", "cpu"])
    _jax_main(j_from_sub, ["--submission", str(tmp_path / "j_merged.pkl"), *from_sub,
                           "--output-dir", str(tmp_path / "j_from_sub")], monkeypatch)
    scored = _one_csv(tmp_path / "p_from_sub")
    _assert_csv_equal(scored, _one_csv(tmp_path / "j_from_sub"))
    assert scored == direct   # the same rows as scoring the agent directly


def test_metric_and_dataset_caching_clis_match_jax(cli_inputs, tmp_path, monkeypatch):
    """run_metric_caching (no map: PDM-Closed's constant-velocity fallback
    in both) and run_dataset_caching (the DiffusionDrive agent's builders
    at tiny_config, sensors read from disk) write what the JAX CLIs write."""
    import diffusiondrive_tpu.script.run_dataset_caching as j_dataset
    import diffusiondrive_tpu.script.run_metric_caching as j_metric
    from diffusiondrive_tpu.common.dataloader import MetricCacheLoader as JLoader

    from diffusiondrive_torch.common.dataloader import MetricCacheLoader
    from diffusiondrive_torch.script import run_dataset_caching, run_metric_caching
    from diffusiondrive_torch.training.dataset import load_feature_target

    c = cli_inputs
    monkeypatch.setenv("NAVSIM_EXP_ROOT", str(tmp_path))
    for main, out, extra in ((run_metric_caching.main, "p", ["device=cpu"]),
                             (lambda a: _jax_main(j_metric, a, monkeypatch), "j", [])):
        main(["--config", "default_metric_caching", f"navsim_log_path={c['logs']}", f"split={c['split']}",
              f"metric_cache_path={tmp_path / out / 'mc'}", f"output_dir={tmp_path / out}", *extra])
    got, want = MetricCacheLoader(tmp_path / "p" / "mc"), JLoader(tmp_path / "j" / "mc")
    assert sorted(got.tokens) == sorted(want.tokens) == sorted(c["tokens"])
    for tok in c["tokens"]:
        a, b = got.get_from_token(tok), want.get_from_token(tok)
        np.testing.assert_array_equal(a.pdm_poses, b.pdm_poses)
        np.testing.assert_array_equal(a.initial_state, b.initial_state)
    snap = (tmp_path / "p" / "config.yaml").read_text().replace(str(tmp_path / "p"), "<out>")
    assert snap == (tmp_path / "j" / "config.yaml").read_text().replace(str(tmp_path / "j"), "<out>") + "device: cpu\n"

    args = ["--agent", "diffusiondrive_agent", "--agent-config", c["agent_cfg"], "--navsim-log-path", c["logs"],
            "--sensor-blobs-path", c["blobs"], "--split", c["split"]]
    run_dataset_caching.main(args + ["--cache-path", str(tmp_path / "p_fc"), "--output-dir", str(tmp_path / "po"),
                                      "--device", "cpu", "--num-workers", "2"])
    _jax_main(j_dataset, args + ["--cache-path", str(tmp_path / "j_fc"), "--output-dir", str(tmp_path / "jo")],
              monkeypatch)
    files = sorted((tmp_path / "p_fc").glob("*/*/*.gz"))
    assert len(files) == 2 * len(c["tokens"])
    for f in files:
        a, b = load_feature_target(f), load_feature_target(tmp_path / "j_fc" / f.relative_to(tmp_path / "p_fc"))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name}:{k}")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the entry points' refusal without a card")
@pytest.mark.parametrize("cli", ["run_training", "run_dataset_caching", "run_metric_caching", "run_pdm_score",
                                 "run_create_submission_pickle", "run_pdm_score_from_submission"])
def test_cli_runs_on_the_card_unless_asked_for_the_cpu(cli, cli_inputs, tmp_path):
    import importlib

    main = importlib.import_module(f"diffusiondrive_torch.script.{cli}").main
    c = cli_inputs
    args = {
        "run_training": ["--agent", "ego_status_mlp_agent", "--cache-path", str(tmp_path / "c"),
                         "--navsim-log-path", c["logs"]],
        "run_dataset_caching": ["--cache-path", str(tmp_path / "c"), "--navsim-log-path", c["logs"]],
        "run_metric_caching": ["--metric-cache-path", str(tmp_path / "c"), "--navsim-log-path", c["logs"]],
        "run_pdm_score": ["--metric-cache-path", c["cache"], "--navsim-log-path", c["logs"]],
        "run_create_submission_pickle": ["--navsim-log-path", c["logs"], "--team-name", "t", "--authors", "a",
                                         "--email", "e", "--institution", "i", "--country", "c"],
        "run_pdm_score_from_submission": ["--submission", "unused.pkl", "--metric-cache-path", c["cache"]],
    }[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args + ["--output-dir", str(tmp_path / "out")])


_ISOLATION = r"""
import sys
sys.path.insert(0, sys.argv[1])
from diffusiondrive_torch.script.cli_common import load_submission
sub = load_submission(sys.argv[2])
traj = next(iter(sub["predictions"][0].values()))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "diffusiondrive_tpu"))
assert not bad, bad
print(type(traj).__module__, traj.poses.shape, len(sub["predictions"][0]))
"""


def test_jax_submission_reads_without_the_jax_package(tmp_path):
    """A fresh interpreter (this one has JAX loaded by conftest) reads a
    JAX-written submission: its classes become the port's, nothing of JAX
    is imported, and another class of the JAX package is refused."""
    from diffusiondrive_tpu.common.dataclasses import SceneFilter as JSceneFilter
    from diffusiondrive_tpu.common.dataclasses import Trajectory as JTrajectory

    from diffusiondrive_torch.script.cli_common import load_submission

    poses = np.arange(24, dtype=np.float32).reshape(8, 3)
    with open(tmp_path / "sub.pkl", "wb") as fp:
        pickle.dump({"team_name": "t", "predictions": [{"tok": JTrajectory(poses)}]}, fp)
    proc = subprocess.run([sys.executable, "-c", _ISOLATION, str(REPO), str(tmp_path / "sub.pkl")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["diffusiondrive_torch.common.dataclasses", "(8,", "3)", "1"]
    with open(tmp_path / "bad.pkl", "wb") as fp:
        pickle.dump({"predictions": [{"tok": JSceneFilter()}]}, fp)
    with pytest.raises(pickle.UnpicklingError, match="SceneFilter"):
        load_submission(tmp_path / "bad.pkl")
