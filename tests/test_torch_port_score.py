"""Parity of the port's PDM scoring path with the JAX package on the CPU: the
scorer on the scenarios of `tests/test_scorer.py`, `test_scorer_oracle.py`,
`test_scorer_edge_cases.py` and `test_golden_scores.py` at O = 4 and O = 96
objects (both sides of the object chunking), per-scene progress
normalisation, the metric cache, the loaders, the runner with the
constant-velocity, human and DiffusionDrive agents, and the CSV.

JAX scores every scenario of a set in one `jax.jit(jax.vmap(...))` call
over scenes (`pdm_score._jitted_score`, as `batched_pdm_score` does), once
per module. Scenarios with fewer than 3 proposals repeat their last one,
which changes no per-scene maximum. Rule: every discrete sub-score (the
multiplicative and weighted terms, the time indices) equal; `score`,
`progress_raw` and `progress_normalized` within 1e-5 x max(1, |JAX|).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_torch.agents.constant_velocity_agent import ConstantVelocityAgent
from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
from diffusiondrive_torch.agents.diffusiondrive.features import TransfuserTargetBuilder
from diffusiondrive_torch.agents.human_agent import HumanAgent
from diffusiondrive_torch.common.dataclasses import SceneFilter, SensorConfig, TrajectorySampling
from diffusiondrive_torch.common.dataloader import MetricCacheLoader, SceneLoader
from diffusiondrive_torch.entry import example_agent_input
from diffusiondrive_torch.evaluate.metric_cache import MetricCache
from diffusiondrive_torch.evaluate.pdm_score import batched_pdm_score, pdm_score, score_scenes
from diffusiondrive_torch.evaluate.runner import SUB_SCORE_COLUMNS, run_pdm_score_evaluation, write_score_csv
from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig, score_proposals
from diffusiondrive_torch.evaluate.simulator import PDMSimulator
from diffusiondrive_tpu.common.dataclasses import SceneFilter as JSceneFilter
from diffusiondrive_tpu.common.dataclasses import SensorConfig as JSensorConfig
from diffusiondrive_tpu.common.dataclasses import Trajectory as JTrajectory
from diffusiondrive_tpu.common.dataloader import MetricCacheLoader as JMetricCacheLoader
from diffusiondrive_tpu.common.dataloader import SceneLoader as JSceneLoader
from diffusiondrive_tpu.evaluate.metric_cache import MetricCache as JMetricCache
from diffusiondrive_tpu.evaluate.pdm_score import _jitted_score
from diffusiondrive_tpu.evaluate.pdm_score import batched_pdm_score as jax_batched_pdm_score
from diffusiondrive_tpu.evaluate.scorer import PDMScorerConfig as JScorerConfig
from diffusiondrive_tpu.evaluate.simulator import PDMSimulator as JSimulator
from diffusiondrive_tpu.evaluate.runner import run_pdm_score_evaluation as jax_run
from diffusiondrive_tpu.evaluate.runner import write_score_csv as jax_write_score_csv

from test_runner import build_caches
from test_scorer import SAMPLING as JSAMPLING
from test_scorer import centerline, make_drivable, make_tracks, straight_states
from test_scorer_oracle import two_lane_drivable
from test_torch_port_model import _port_config
from test_train import tiny_config

T = 41
B = 3   # proposals per stacked scene
SAMPLING = TrajectorySampling(num_poses=40, interval_length=0.1)
DISCRETE = ("no_at_fault_collisions", "drivable_area_compliance", "driving_direction_compliance", "ttc",
            "comfort", "collision_time_idcs", "ttc_time_idcs")
FLOATS = ("score", "progress_raw", "progress_normalized")
FLOAT_TOL = 1e-5


def _hard_brake():
    states = straight_states(15.0)
    time = np.arange(T) * 0.1
    v = np.maximum(15.0 - 6.0 * time, 0.0)
    states[:, 0] = np.concatenate([[0], np.cumsum(v[:-1] * 0.1)])
    states[:, 3] = v
    states[:, 5] = np.where(v > 0, -6.0, 0.0)
    return states


def _reverse():
    rev = straight_states(10.0).copy()
    rev[:, 0] = 100.0 - 10.0 * 0.1 * np.arange(T)
    rev[:, 2] = np.pi
    return rev


def _oncoming_lane():
    d = make_drivable(width=30.0)
    lane = np.array([[-20, 2], [220, 2], [220, 10], [-20, 10]], np.float32)
    d.polygons[1, :4] = lane
    d.polygons[1, 4:] = lane[3]
    return d


def _non_agent(tracks):
    tracks.is_agent[:] = False
    return tracks


def scenarios(num_objects):
    """(name, states (n, 41, 11), tracks, drivable) of every scorer test."""
    s = straight_states
    tr = lambda *a, **k: make_tracks(*a, num_objects=num_objects, **k)  # noqa: E731
    lead = dict(boxes=[(12.0, 0.0, 0.0, 4.5, 2.0)], velocities=[(9.0, 0.0)])
    return [
        ("clean", [s(10.0), s(10.0)], tr(), make_drivable()),
        ("stopped_ahead", [s(10.0), s(10.0)], tr(boxes=[(20.0, 0.0, 0.0, 4.5, 2.0)]), make_drivable()),
        ("red_light", [s(10.0), s(10.0)], tr(boxes=[(20.0, 0.0, 0.0, 4.5, 2.0)], red_lights=(0,)), make_drivable()),
        ("rear_ended", [s(2.0), s(2.0)], tr(boxes=[(-15.0, 0.0, 0.0, 4.5, 2.0)], velocities=[(12.0, 0.0)]),
         make_drivable()),
        ("offroad", [s(10.0), s(10.0, y=30.0)], tr(), make_drivable()),
        ("progress", [s(10.0), s(5.0)], tr(), make_drivable()),
        ("golden_tailgate", [s(10.0), s(10.0)], tr(**lead), make_drivable()),
        ("golden_crash", [s(10.0), s(2.0)], tr(boxes=[(20.0, 0.0, 0.0, 4.5, 2.0)]), make_drivable()),
        ("stopped_ego", [s(0.0)], tr(boxes=[(8.0, 0.0, np.pi, 4.0, 2.0)], velocities=[(-5.0, 0.0)]),
         make_drivable()),
        ("stopped_track", [s(10.0)], tr(boxes=[(20.0, 0.0, 0.0, 4.0, 2.0)]), make_drivable()),
        ("object_half", [s(10.0)], _non_agent(tr(boxes=[(20.0, 0.0, 0.0, 4.0, 2.0)])), make_drivable()),
        ("active_front", [s(10.0)], tr(boxes=[(20.0, 0.0, 0.0, 4.0, 2.0)], velocities=[(1.0, 0.0)]),
         make_drivable()),
        ("lateral_one_lane", [s(10.0)], tr(boxes=[(0.0, 2.05, 0.0, 4.0, 2.0)], velocities=[(10.0, 0.0)]),
         make_drivable()),
        ("lateral_two_lanes", [s(10.0)], tr(boxes=[(0.0, 2.05, 0.0, 4.0, 2.0)], velocities=[(10.0, 0.0)]),
         two_lane_drivable(split_y=0.0)),
        ("active_rear", [s(5.0)], tr(boxes=[(-8.0, 0.0, 0.0, 4.0, 2.0)], velocities=[(15.0, 0.0)]),
         make_drivable()),
        ("ttc_first_event", [s(10.0)], tr(boxes=[(0.0, 2.05, 0.0, 4.0, 2.0)], velocities=[(12.0, 0.0)]),
         make_drivable()),
        ("below_threshold", [s(0.5), s(0.5, y=5.0)], tr(boxes=[(2.0, 5.0, 0.0, 4.0, 2.0)]), make_drivable()),
        ("direction_tiers", [s(1.5), s(3.0), s(8.0)], tr(), two_lane_drivable(split_y=4.0, on_route=(False, False))),
        ("reverse", [s(10.0), _reverse()], tr(), make_drivable()),
        ("oncoming_lane", [s(10.0, y=-5.0)] * 2, tr(), _oncoming_lane()),
        ("hard_brake", [_hard_brake(), s(10.0)], tr(), make_drivable()),
        # per-scene normalisation: its best progress (8 m) differs from the other scenes' (40 m)
        ("slow_scene", [s(2.0), s(1.0)], tr(), make_drivable()),
        ("many_objects", [s(10.0), s(6.0), s(3.0)],
         tr(boxes=[(10.0 + 7.0 * o, 3.5 * ((o % 3) - 1), 0.1 * o, 4.0, 2.0) for o in range(min(num_objects, 20))],
            velocities=[(3.0 * (o % 4), 0.5 * ((o % 2) - 0.5)) for o in range(min(num_objects, 20))]),
         make_drivable()),
    ]


def stack(scen):
    """Stacked arrays in `score_proposals`' argument order (scene dim first)."""
    states = np.stack([np.stack(list(st) + [st[-1]] * (B - len(st))) for _, st, _, _ in scen]).astype(np.float32)
    cols = []
    for _, _, t, d in scen:
        cols.append((t.poses, t.extents, t.valid, t.is_agent, t.is_red_light, t.is_stopped,
                     t.previously_collided, t.global_to_local, d.polygons, d.valid, d.layers, d.on_route,
                     centerline()))
    return [states] + [np.stack(c) for c in zip(*cols)]


@pytest.fixture(scope="module")
def scored():
    """{O: (names, port ScorerOutput as numpy, JAX ScorerOutput as numpy)}."""
    out = {}
    score_fn = _jitted_score(JSimulator(JSAMPLING), JScorerConfig())
    for num_objects in (4, 96):
        scen = scenarios(num_objects)
        arrays = stack(scen)
        want = jax.device_get(score_fn(*[jnp.asarray(a) for a in arrays]))
        got = score_proposals(*[torch.from_numpy(a) for a in arrays], SAMPLING)
        out[num_objects] = ([n for n, *_ in scen], {k: v.numpy() for k, v in got._asdict().items()},
                            {k: np.asarray(v) for k, v in want._asdict().items()})
    return out


def _check(got, want, what=""):
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    for k in FLOATS:
        err = np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max()
        assert err <= FLOAT_TOL * max(1.0, np.abs(want[k]).max()), f"{what} {k}: {err}"


@pytest.mark.parametrize("num_objects", [4, 96], ids=["O4_one_pass", "O96_chunked"])
def test_score_proposals_matches_jax(scored, num_objects):
    names, got, want = scored[num_objects]
    assert got["score"].shape == (len(names), B)
    assert got["score"].dtype == np.float32 and got["collision_time_idcs"].dtype == np.float32
    _check(got, want, f"O={num_objects}")
    # every metric takes both of its values somewhere in the set
    for k in ("no_at_fault_collisions", "drivable_area_compliance", "ttc", "comfort"):
        assert (got[k] == 0).any() and (got[k] == 1).any(), k
    assert set(np.unique(got["driving_direction_compliance"])) == {0.0, 0.5, 1.0}


def test_chunked_scores_equal_one_pass(scored):
    """96 objects, 6 chunks of 16, against the same scenes with 4 objects."""
    _, got4, _ = scored[4]
    _, got96, _ = scored[96]
    for k in got4:
        np.testing.assert_array_equal(got96[k], got4[k], err_msg=k)


def test_golden_and_oracle_values(scored):
    names, got, _ = scored[96]
    row = {n: {k: v[i] for k, v in got.items()} for i, n in enumerate(names)}
    g = row["golden_tailgate"]
    np.testing.assert_allclose(g["score"][:2], 7.0 / 12.0, atol=1e-5)
    np.testing.assert_allclose(g["ttc_time_idcs"][:2], 40.0)
    np.testing.assert_allclose(g["progress_raw"][:2], 40.0, atol=0.05)
    c = row["golden_crash"]
    assert c["no_at_fault_collisions"][0] == 0.0 and c["collision_time_idcs"][0] == 14.0 and c["score"][0] == 0.0
    np.testing.assert_allclose(c["score"][1], 1.0, atol=1e-5)
    np.testing.assert_allclose(c["progress_raw"][1], 8.0, atol=0.05)
    assert row["stopped_track"]["ttc_time_idcs"][0] == 5.0 and row["active_front"]["collision_time_idcs"][0] == 16
    np.testing.assert_allclose(row["object_half"]["score"][0], 0.5 * 7.0 / 12.0, atol=1e-6)
    np.testing.assert_array_equal(row["direction_tiers"]["driving_direction_compliance"], [1.0, 0.5, 0.0])


def test_progress_is_normalised_per_scene(scored):
    """JAX normalises over one scene's proposals (a vmap lane); the port's
    batch of scenes must too: the slow scene's best (8 m) is its 1.0."""
    names, got, want = scored[4]
    i = names.index("slow_scene")
    np.testing.assert_allclose(got["progress_raw"][i, :2], [8.0, 4.0], atol=0.05)
    np.testing.assert_allclose(got["progress_normalized"][i, :2], [1.0, 0.5], atol=1e-3)
    j = names.index("progress")
    np.testing.assert_allclose(got["progress_normalized"][j, :2], [1.0, 0.5], atol=1e-3)
    np.testing.assert_allclose(got["progress_normalized"][i], want["progress_normalized"][i], atol=FLOAT_TOL)


# --------------------------------------------------------------------------- #
# Metric cache, loaders, scenes
# --------------------------------------------------------------------------- #


def _cache(pdm_speed=10.0, boxes=((30.0, 0.0, 0.0, 4.5, 2.0),)):
    return dict(token="tok0", log_name="log0",
                pdm_poses=straight_states(pdm_speed)[:, :3].astype(np.float64),
                pdm_times=np.arange(T) * 0.1,
                initial_state=straight_states(10.0)[0].astype(np.float64),
                tracks=make_tracks(boxes=list(boxes)), drivable=make_drivable(),
                centerline=centerline(), route_lane_ids=["lane_a", "lane_b"])


def test_metric_cache_reads_the_jax_npz_and_back(tmp_path):
    JMetricCache(**_cache()).save(tmp_path / "jax" / "metric_cache.npz")
    got = MetricCache.load(tmp_path / "jax" / "metric_cache.npz")
    want = JMetricCache.load(tmp_path / "jax" / "metric_cache.npz")
    assert (got.token, got.log_name, got.route_lane_ids) == ("tok0", "log0", ["lane_a", "lane_b"])
    for part in ("tracks", "drivable"):
        for k, v in vars(getattr(want, part)).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(getattr(got, part), k), v, err_msg=k)
    np.testing.assert_array_equal(got.pdm_poses, want.pdm_poses)
    np.testing.assert_array_equal(got.centerline, want.centerline)
    got.save(tmp_path / "port" / "metric_cache.npz")
    back = JMetricCache.load(tmp_path / "port" / "metric_cache.npz")
    np.testing.assert_array_equal(back.tracks.poses, want.tracks.poses)
    assert back.route_lane_ids == want.route_lane_ids


def test_scene_and_cache_loaders_match_jax(synthetic_log, tmp_path):
    logs_dir, blobs_dir = synthetic_log
    loader = SceneLoader(logs_dir, blobs_dir, SceneFilter(num_history_frames=4, num_future_frames=10,
                                                          frame_interval=1),
                         SensorConfig.build_no_sensors(), build_map_api=False)
    jloader = JSceneLoader(logs_dir, blobs_dir, JSceneFilter(num_history_frames=4, num_future_frames=10,
                                                             frame_interval=1),
                           JSensorConfig.build_no_sensors(), build_map_api=False)
    assert loader.tokens == jloader.tokens and len(loader) == 2
    assert loader.get_tokens_list_per_log() == jloader.get_tokens_list_per_log()
    for token in loader.tokens:
        scene, jscene = loader.get_scene_from_token(token), jloader.get_scene_from_token(token)
        np.testing.assert_array_equal(scene.get_future_trajectory().poses, jscene.get_future_trajectory().poses)
        np.testing.assert_array_equal(scene.get_history_trajectory().poses, jscene.get_history_trajectory().poses)
        for a, b in zip(loader.get_agent_input_from_token(token).ego_statuses,
                        jloader.get_agent_input_from_token(token).ego_statuses):
            for k in ("ego_pose", "ego_velocity", "ego_acceleration", "driving_command"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert scene.scene_metadata.__dict__ == jscene.scene_metadata.__dict__
        # the target builder reads the port's own Scene as it read JAX's
        cfg = tiny_config()
        got = TransfuserTargetBuilder(_port_config(cfg)).compute_targets(scene)
        want = TransfuserTargetBuilder(_port_config(cfg)).compute_targets(jscene)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    build_caches(loader.tokens, tmp_path / "cache")
    cache_loader, jcache_loader = MetricCacheLoader(tmp_path / "cache"), JMetricCacheLoader(tmp_path / "cache")
    assert sorted(cache_loader.tokens) == sorted(jcache_loader.tokens) == sorted(loader.tokens)
    np.testing.assert_array_equal(cache_loader[0].tracks.poses, jcache_loader[0].tracks.poses)


def test_sensor_blobs_and_map_api_raise_until_ported(synthetic_log):
    logs_dir, blobs_dir = synthetic_log
    scene_filter = SceneFilter(num_history_frames=4, num_future_frames=10, frame_interval=1)
    loader = SceneLoader(logs_dir, blobs_dir, scene_filter, SensorConfig.build_all_sensors([3]),
                         build_map_api=False)
    with pytest.raises(NotImplementedError, match="ROADMAP item 18"):
        loader.get_agent_input_from_token(loader.tokens[0])
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        SceneLoader(logs_dir, blobs_dir, scene_filter).get_scene_from_token(loader.tokens[0])


# --------------------------------------------------------------------------- #
# pdm_score, the runner and the CSV
# --------------------------------------------------------------------------- #


def _rows_equal(rows, jrows):
    assert [r["token"] for r in rows] == [r["token"] for r in jrows]
    for r, j in zip(rows, jrows):
        assert r["valid"] == j["valid"], r
        for c in SUB_SCORE_COLUMNS:
            assert abs(r[c] - j[c]) <= FLOAT_TOL, (r["token"], c, r[c], j[c])


def _read_csv(path):
    with open(path, newline="") as fp:
        return list(csv.reader(fp))


@pytest.fixture(scope="module")
def runner_setup(synthetic_log, tmp_path_factory):
    logs_dir, blobs_dir = synthetic_log
    cache_dir = tmp_path_factory.mktemp("runner") / "metric_cache"
    loader = SceneLoader(logs_dir, blobs_dir, SceneFilter(num_history_frames=4, num_future_frames=10,
                                                          frame_interval=1),
                         SensorConfig.build_no_sensors(), build_map_api=False)
    jloader = JSceneLoader(logs_dir, blobs_dir, JSceneFilter(num_history_frames=4, num_future_frames=10,
                                                             frame_interval=1),
                           JSensorConfig.build_no_sensors(), build_map_api=False)
    build_caches(loader.tokens, cache_dir)
    return loader, jloader, cache_dir


def test_runner_cv_and_human_rows_and_csv_equal_jax(runner_setup, tmp_path):
    from diffusiondrive_tpu.agents.constant_velocity_agent import ConstantVelocityAgent as JCV
    from diffusiondrive_tpu.agents.human_agent import HumanAgent as JHuman

    loader, jloader, cache_dir = runner_setup
    for agent, jagent in ((ConstantVelocityAgent(), JCV()), (HumanAgent(), JHuman())):
        rows = run_pdm_score_evaluation(agent, loader, MetricCacheLoader(cache_dir), batch_size=8, device="cpu")
        jrows = jax_run(jagent, jloader, JMetricCacheLoader(cache_dir), batch_size=8)
        assert len(rows) == 2 and all(r["valid"] and r["score"] > 0.9 for r in rows), rows
        _rows_equal(rows, jrows)

    # the CSV, written with `csv`, against JAX's pandas one (one invalid row too)
    rows.append({"token": "zz_failed", "valid": False, **{c: float("nan") for c in SUB_SCORE_COLUMNS}})
    jrows.append(dict(rows[-1]))
    got = _read_csv(write_score_csv(rows, tmp_path / "port"))
    want = _read_csv(jax_write_score_csv(jrows, tmp_path / "jax"))
    assert got[0] == want[0] == ["", "token", "valid", *SUB_SCORE_COLUMNS]
    assert len(got) == len(want) == len(rows) + 2
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3], (g, w)
        for a, b in zip(g[3:], w[3:]):
            assert (a == b == "") or abs(float(a) - float(b)) <= FLOAT_TOL, (g, w)
    assert got[-1][1:3] == ["average", "False"]


class _InMemoryLoader:
    """Tokens and raw-sensor agent inputs held in memory (the port's
    `SceneLoader` reads no sensor blobs yet)."""

    def __init__(self, tokens, config):
        self.tokens = list(tokens)
        self._inputs = {tok: example_agent_input(config, seed=i, num_points=3000, camera_shape=(88, 900))
                        for i, tok in enumerate(self.tokens)}

    def get_agent_input_from_token(self, token):
        return self._inputs[token]


class _RecordingAgent(DiffusionDriveAgent):
    """Keeps every trajectory its batched forward returns."""

    def forward(self, features):
        out = super().forward(features)
        self.trajectories.append(out["trajectory"])
        return out


def test_runner_with_the_diffusiondrive_agent_equals_jax_scores(runner_setup):
    """The port's agent (tiny config, raw sensors, float32) through the
    port's runner on the CPU: 3 tokens in a padded batch of 8, all rows
    valid, each score equal to JAX's `batched_pdm_score` of the same
    trajectories and caches."""
    _, _, cache_dir = runner_setup
    cache_loader = MetricCacheLoader(cache_dir)
    tokens = sorted(cache_loader.tokens)
    cfg = _port_config(tiny_config())
    agent = _RecordingAgent(cfg, dtype=torch.float32, seed=0, preprocess_on_device=True, device="cpu")
    agent.trajectories = []
    loader = _InMemoryLoader(tokens + ["no_cache"], cfg)
    rows = run_pdm_score_evaluation(agent, loader, cache_loader, batch_size=8, device="cpu")
    assert [r["token"] for r in rows] == tokens and all(r["valid"] for r in rows), rows
    assert len(agent.trajectories) == 1 and agent.trajectories[0].shape == (8, cfg.num_poses, 3)
    trajs = [JTrajectory(p) for p in agent.trajectories[0][: len(tokens)]]
    jcaches = [JMetricCache.load(cache_loader.metric_cache_paths[t]) for t in tokens]
    want = jax_batched_pdm_score(jcaches + [jcaches[-1]] * (8 - len(tokens)),
                                 trajs + [trajs[-1]] * (8 - len(tokens)), JSimulator(JSAMPLING))
    for r, w in zip(rows, want):
        assert abs(r["score"] - w.score) <= FLOAT_TOL and abs(r["ego_progress"] - w.ego_progress) <= FLOAT_TOL
        for c in ("no_at_fault_collisions", "drivable_area_compliance", "time_to_collision_within_bound",
                  "comfort", "driving_direction_compliance"):
            assert r[c] == getattr(w, c), (c, r, w)


def test_pdm_score_runs_on_cuda_by_default_and_scores_both_proposals():
    cache = MetricCache(**_cache(pdm_speed=5.0, boxes=()))
    poses = np.zeros((8, 3), np.float32)
    poses[:, 0] = 10.0 * 0.5 * np.arange(1, 9)
    from diffusiondrive_torch.common.dataclasses import Trajectory

    traj = Trajectory(poses)
    simulator = PDMSimulator(SAMPLING)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pdm_score(cache, traj, simulator)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_pdm_score_evaluation(ConstantVelocityAgent(), None, None)
    one = pdm_score(cache, traj, simulator, device="cpu")
    assert one.score > 0.95 and one.no_at_fault_collisions == 1.0
    out = score_scenes([cache] * 2, [traj] * 2, simulator, PDMScorerConfig(), device="cpu")
    assert out.score.shape == (2, 2) and isinstance(out.score, np.ndarray)
    # the PDM-Closed proposal slows from 10 to 5 m/s, the model's keeps 10
    assert 0.5 < out.progress_normalized[0, 0] < 0.8 and out.progress_normalized[0, 1] == 1.0
    assert [r.score for r in batched_pdm_score([cache] * 3, [traj] * 3, simulator, device="cpu")] == [one.score] * 3
