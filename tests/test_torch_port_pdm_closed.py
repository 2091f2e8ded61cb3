"""Parity of the port's PDM-Closed planner and metric caching with the JAX
package on the CPU.

The planner runs on the scenarios of `tests/test_pdm_closed.py`,
`test_planner_scenarios.py` and `test_route_correction.py` (parked vehicle,
free road, red light, near red light, curve, corrected route), and on the
constant-velocity fallback without a map or a starting lane. Each
scenario's scene and map are built once and run through both packages;
JAX's planner is observed by wrapping its `_generate_proposals` and its
jitted `_score_scene`, so every JAX planner call runs as in the package.
Rule: everything upstream of the scorer is float64 numpy on both sides, so
the 15 proposals and the scorer's input arrays are equal bit for bit; the
scores are within 1e-4 x max(1, |JAX|); the chosen proposal is JAX's
wherever JAX's top-two gap exceeds that tolerance, and otherwise scores
within it of JAX's maximum (`chip_smoke.check_planner_choice`); the
planned poses are the chosen proposal's.

Metric caching runs `cache_data` of both packages on three scenes of the
1440-object city grid of `tests/test_map_scale.py`, loaded by each
package's `SceneLoader` with its default arguments from a `.ddmap.pkl`
that JAX wrote, under `NUPLAN_MAPS_ROOT`.
"""

import copy
import csv
import dataclasses

import numpy as np
import pytest
import torch

import diffusiondrive_torch.common.dataclasses as port_dataclasses
import diffusiondrive_tpu.common.dataclasses as jax_dataclasses
import diffusiondrive_tpu.evaluate.pdm_score as jax_pdm_score
from diffusiondrive_torch.agents.constant_velocity_agent import ConstantVelocityAgent
from diffusiondrive_torch.common.dataclasses import SceneFilter, SensorConfig, TrajectorySampling
from diffusiondrive_torch.common.dataloader import MetricCacheLoader, SceneLoader
from diffusiondrive_torch.evaluate.metric_cache import MetricCache
from diffusiondrive_torch.evaluate.pdm_score import batched_pdm_score, stack_scenes
from diffusiondrive_torch.evaluate.simulator import PDMSimulator
from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData
from diffusiondrive_torch.planning.metric_caching import MetricCacheProcessor, cache_data
from diffusiondrive_torch.planning.pdm_closed.observation_builder import ego_state_array_from_scene
from diffusiondrive_torch.planning.pdm_closed.planner import PDMClosedPlanner
from diffusiondrive_torch.utils.synthetic import build_synthetic_log
from diffusiondrive_tpu.agents.constant_velocity_agent import ConstantVelocityAgent as JCVAgent
from diffusiondrive_tpu.common.dataclasses import SceneFilter as JSceneFilter
from diffusiondrive_tpu.common.dataclasses import SensorConfig as JSensorConfig
from diffusiondrive_tpu.common.dataloader import MetricCacheLoader as JMetricCacheLoader
from diffusiondrive_tpu.common.dataloader import SceneLoader as JSceneLoader
from diffusiondrive_tpu.evaluate.observation import MapLayer
from diffusiondrive_tpu.evaluate.pdm_score import batched_pdm_score as jax_batched_pdm_score
from diffusiondrive_tpu.evaluate.simulator import PDMSimulator as JSimulator
from diffusiondrive_tpu.planning.map_api import LocalMapAPI as JLocalMapAPI
from diffusiondrive_tpu.planning.map_api import MapObjectData as JMapObjectData
from diffusiondrive_tpu.planning.metric_caching import MetricCacheProcessor as JMetricCacheProcessor
from diffusiondrive_tpu.planning.metric_caching import cache_data as jax_cache_data
from diffusiondrive_tpu.planning.pdm_closed.planner import PDMClosedPlanner as JPDMClosedPlanner
from diffusiondrive_tpu.utils.synthetic import build_synthetic_log as jax_build_synthetic_log
from diffusiondrive_tpu.utils.synthetic import make_straight_map

from chip_smoke import PDM_TOL as TOL
from chip_smoke import check_planner_choice
from test_map_scale import make_city_map
from test_planner_scenarios import make_curved_map

SAMPLING = TrajectorySampling(num_poses=40, interval_length=0.1)
CITY_SCENES = 3


def to_port_map(jmap) -> LocalMapAPI:
    """The port's `LocalMapAPI` of the same objects as a JAX one."""
    return LocalMapAPI([MapObjectData(**dataclasses.asdict(o)) for o in jmap._objects], jmap.map_name)


def near_red_map():
    """`test_planner_stops_for_near_red_light`'s map: lane1 ends at x=20,
    lane2 (x in [20, 60]) is a lane connector."""
    objects, width = [], 8.0
    for i, (x0, x1, layer) in enumerate(
        [(-20, 20, MapLayer.LANE), (20, 60, MapLayer.LANE_CONNECTOR), (60, 200, MapLayer.LANE)]
    ):
        rect = np.array([[x0, -width / 2], [x1, -width / 2], [x1, width / 2], [x0, width / 2]], float)
        rb_token, lane_token = f"rb{i + 1}", f"lane{i + 1}"
        objects.append(JMapObjectData(token=rb_token, layer=MapLayer.ROADBLOCK, polygon=rect,
                                      outgoing=[f"rb{i + 2}"] if i < 2 else [],
                                      incoming=[f"rb{i}"] if i > 0 else []))
        bx = np.arange(x0, x1 + 1.0, 1.0)
        baseline = np.stack([bx, np.zeros_like(bx), np.zeros_like(bx)], axis=-1)
        objects.append(JMapObjectData(token=lane_token, layer=layer, polygon=rect, baseline=baseline,
                                      outgoing=[f"lane{i + 2}"] if i < 2 else [],
                                      incoming=[f"lane{i}"] if i > 0 else [],
                                      parent_token=rb_token, speed_limit=15.0))
    return JLocalMapAPI(objects, "red")


def red_connector_map():
    """`test_planner_stops_for_red_light`'s map: the straight road with lane2
    a lane connector."""
    jmap = make_straight_map()
    jmap.get_map_object("lane2").layer = MapLayer.LANE_CONNECTOR
    return JLocalMapAPI(jmap._objects, "synthetic")


def _no_agents(scene):
    for frame in scene.frames:
        ann = frame.annotations
        ann.boxes = np.zeros((0, 7), np.float32)
        ann.names, ann.instance_tokens, ann.track_tokens = [], [], []
        ann.velocity_3d = np.zeros((0, 3), np.float32)


def _route(ids, red=None):
    def edit(scene):
        for frame in scene.frames:
            frame.roadblock_ids = list(ids)
            if red is not None:
                frame.traffic_lights = [("lane2", red)]
    return edit


def _free(ids, red=None):
    def edit(scene):
        _no_agents(scene)
        _route(ids, red)(scene)
    return edit


# name -> (scene edit, JAX map or None)
SCENARIOS = {
    "parked_vehicle": (_route(["rb1", "rb2", "rb3"]), make_straight_map),
    "free_road": (_free(["rb1", "rb2", "rb3"]), make_straight_map),
    "red_light": (_free(["rb1", "rb2", "rb3"], red=True), red_connector_map),
    "near_red_light": (_free(["rb1", "rb2", "rb3"], red=True), near_red_map),
    "curve": (_free(["rb1", "rb2"]), make_curved_map),
    "corrected_route": (_route(["rb2", "rb3"]), make_straight_map),
    "mapless": (_route(["rb1", "rb2", "rb3"]), None),
    "no_starting_lane": (_route(["rb_elsewhere"]), make_straight_map),
}
FALLBACKS = ("mapless", "no_starting_lane")   # JAX's constant-velocity fallback, no scoring


def scene_pair(synthetic_log, edit):
    """The first scene of the shared synthetic log (frame interval 14), as
    the port's and JAX's `Scene`, both edited the same way."""
    logs_dir, blobs_dir = synthetic_log
    kwargs = dict(num_history_frames=4, num_future_frames=10, frame_interval=14)
    loader = SceneLoader(logs_dir, blobs_dir, SceneFilter(**kwargs), SensorConfig.build_no_sensors(),
                         build_map_api=False)
    jloader = JSceneLoader(logs_dir, blobs_dir, JSceneFilter(**kwargs), JSensorConfig.build_no_sensors(),
                           build_map_api=False)
    scene = copy.deepcopy(loader.get_scene_from_token(loader.tokens[0]))
    jscene = copy.deepcopy(jloader.get_scene_from_token(jloader.tokens[0]))
    edit(scene)
    edit(jscene)
    return scene, jscene


class JaxPlannerRecorder:
    """Wraps the JAX planner's `_generate_proposals` and the jitted
    `_score_scene` it reaches, keeping the proposals, the scorer's input
    arrays and the (15,) scores of the last call."""

    def __init__(self, mp):
        self.last = {}
        gen, score_scene = JPDMClosedPlanner._generate_proposals, jax_pdm_score._score_scene

        def generate(planner, *args, **kwargs):
            self.last["proposals"] = gen(planner, *args, **kwargs)
            return self.last["proposals"]

        def wrapped_score_scene(*args, **kwargs):
            run = score_scene(*args, **kwargs)

            def recorded(*inputs):
                out = run(*inputs)
                self.last["inputs"] = [np.asarray(x) for x in inputs]
                self.last["scores"] = np.asarray(out.score[0])
                return out
            return recorded

        mp.setattr(JPDMClosedPlanner, "_generate_proposals", generate)
        mp.setattr(jax_pdm_score, "_score_scene", wrapped_score_scene)


@pytest.fixture(scope="module")
def planned(synthetic_log):
    """{scenario: the port's and JAX's planner after the call, their poses,
    the port's scene and JAX's record}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        rec = JaxPlannerRecorder(mp)
        for name, (edit, make_map) in SCENARIOS.items():
            scene, jscene = scene_pair(synthetic_log, edit)
            jmap = make_map() if make_map else None
            jplanner, planner = JPDMClosedPlanner(), PDMClosedPlanner(device="cpu")
            rec.last = {}
            jposes, jtimes = jplanner.compute_planner_trajectory(jscene, jmap)
            poses, times = planner.compute_planner_trajectory(scene, to_port_map(jmap) if jmap else None)
            np.testing.assert_array_equal(times, jtimes)
            out[name] = dict(planner=planner, poses=poses, jplanner=jplanner, jposes=jposes, scene=scene,
                             rec=dict(rec.last))
    return out


@pytest.mark.parametrize("name", [n for n in SCENARIOS if n not in FALLBACKS])
def test_planner_matches_jax(planned, name):
    p = planned[name]
    planner, poses, jplanner, jposes, rec = p["planner"], p["poses"], p["jplanner"], p["jposes"], p["rec"]
    # the 15 proposals (float64 numpy on both sides) and every scorer input bit for bit
    assert planner.proposals.shape == (15, 51, 11)
    np.testing.assert_array_equal(planner.proposals, rec["proposals"])
    ego = ego_state_array_from_scene(p["scene"])
    for i, (got, want) in enumerate(zip(planner.scorer_inputs(planner.proposals, ego), rec["inputs"])):
        assert got.dtype == want.dtype, (i, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"scorer input {i}")
    chosen = check_planner_choice(name, planner.scores, rec["scores"].astype(np.float64))
    jbest = int(np.argmax(rec["scores"]))
    np.testing.assert_array_equal(poses, planner.proposals[chosen, :, :3])
    if chosen == jbest:
        np.testing.assert_array_equal(poses, jposes)
    # the corrected route, the observation and the drivable map equal JAX's
    assert list(planner._route_roadblock_dict) == list(jplanner._route_roadblock_dict)
    assert list(planner._route_lane_dict) == list(jplanner._route_lane_dict)
    for part in ("observation", "drivable_area_map"):
        for k, v in vars(getattr(jplanner, part)).items():
            got = getattr(getattr(planner, part), k)
            if v is None:
                assert got is None, k
            else:
                np.testing.assert_array_equal(got, v, err_msg=f"{part}.{k}")
    np.testing.assert_array_equal(planner.centerline.coords, jplanner.centerline.coords)


def test_planner_scenarios_behave_as_in_jax_tests(planned):
    """The assertions of the JAX scenario tests, on the port's poses."""
    parked = planned["parked_vehicle"]["poses"]
    assert parked.shape == (51, 3) and abs(parked[0, 0] - 6.0) <= 1.5 and parked[-1, 0] < 16.0
    assert np.linalg.norm(parked[-1, :2] - parked[-2, :2]) / 0.1 < 5.0
    free = planned["free_road"]["poses"]
    assert np.linalg.norm(free[-1, :2] - free[-2, :2]) / 0.1 > 5.0
    red = planned["red_light"]["planner"].observation
    assert red.is_red_light.any() and red.rings_override is not None
    near = planned["near_red_light"]["poses"]
    assert near[-1, 0] < 21.0 and np.linalg.norm(near[-1, :2] - near[-2, :2]) / 0.1 < 1.0
    curve = planned["curve"]["poses"]
    assert curve[-1, 1] > 1.0 and curve[-1, 2] > 0.1
    assert "rb1" in planned["corrected_route"]["planner"]._route_roadblock_dict


@pytest.mark.parametrize("name", FALLBACKS)
def test_planner_without_map_or_lane_takes_the_constant_velocity_fallback(planned, name):
    p = planned[name]
    np.testing.assert_array_equal(p["poses"], p["jposes"])
    assert p["rec"] == {} and p["planner"].scores is None and p["planner"].centerline is None
    np.testing.assert_allclose(np.diff(p["poses"][:, 0]), 4.0 * 0.1, rtol=1e-12)
    if name == "no_starting_lane":   # the drivable map and observation were built before the fallback
        for part in ("observation", "drivable_area_map"):
            for k, v in vars(getattr(p["jplanner"], part)).items():
                if v is not None:
                    np.testing.assert_array_equal(getattr(getattr(p["planner"], part), k), v, err_msg=k)


def test_planner_scorer_inputs_have_the_batch_path_dtypes(planned, tmp_path):
    """What the planner hands `simulate_and_score` has the dtypes that
    `stack_scenes` gives the runner's batches from a metric cache."""
    planner = planned["parked_vehicle"]["planner"]
    ego = ego_state_array_from_scene(planned["parked_vehicle"]["scene"])
    inputs = planner.scorer_inputs(planner.proposals, ego)
    cache = MetricCache(token="t", log_name="l", pdm_poses=planner.proposals[0, :, :3],
                        pdm_times=np.arange(51) * 0.1, initial_state=ego, tracks=planner.observation,
                        drivable=planner.drivable_area_map,
                        centerline=planner.centerline.coords.astype(np.float32), route_lane_ids=[])
    cache.save(tmp_path / "metric_cache.npz")
    cache = MetricCache.load(tmp_path / "metric_cache.npz")
    from diffusiondrive_torch.common.dataclasses import Trajectory

    proposals, ctx = stack_scenes([cache], [Trajectory(np.zeros((8, 3), np.float32))], SAMPLING)
    assert [a.dtype for a in inputs] == [proposals.dtype] + [a.dtype for a in ctx]
    assert [a.shape[1:] for a in inputs[2:]] == [a.shape[1:] for a in ctx[1:]]


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    for call in (lambda: PDMClosedPlanner(), lambda: MetricCacheProcessor(str(tmp_path)),
                 lambda: cache_data(None, str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert MetricCacheProcessor(str(tmp_path), device="cpu").device == torch.device("cpu")


# --------------------------------------------------------------------------- #
# Metric caching on the city grid
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def city_caches(tmp_path_factory):
    """Both packages' `cache_data` over the same three scenes of the city
    grid (a parked vehicle ahead), each package's `SceneLoader` with its
    default arguments, the map a JAX-written `.ddmap.pkl`."""
    root = tmp_path_factory.mktemp("city")
    logs_dir, blobs_dir = jax_build_synthetic_log(
        root / "data", num_frames=CITY_SCENES + 13, roadblock_ids=tuple(f"rb_0_{i}" for i in range(12)))
    port_logs, _ = build_synthetic_log(root / "port_data", num_frames=CITY_SCENES + 13,
                                       roadblock_ids=tuple(f"rb_0_{i}" for i in range(12)))
    make_city_map().save(root / "maps" / "synthetic.ddmap.pkl")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dataclasses, "NUPLAN_MAPS_ROOT", str(root / "maps"))
        mp.setattr(port_dataclasses, "NUPLAN_MAPS_ROOT", str(root / "maps"))
        loader = SceneLoader(logs_dir, blobs_dir, SceneFilter(frame_interval=1))
        jloader = JSceneLoader(logs_dir, blobs_dir, JSceneFilter(frame_interval=1))
        assert len(loader.tokens) == CITY_SCENES
        scene = loader.get_scene_from_token(loader.tokens[0])
        assert isinstance(scene.map_api, LocalMapAPI) and len(scene.map_api._objects) == 1440
        paths = cache_data(loader, str(root / "port"), num_workers=2, device="cpu")
        jpaths = jax_cache_data(jloader, str(root / "jax"), num_workers=2)
        processor = MetricCacheProcessor(str(root / "port"), device="cpu")
    return dict(root=root, loader=loader, paths=paths, jpaths=jpaths, scene=scene, processor=processor,
                port_log=port_logs / "demo_log.pkl", jax_log=logs_dir / "demo_log.pkl")


def test_synthetic_log_is_the_jax_one(city_caches):
    assert city_caches["port_log"].read_bytes() == city_caches["jax_log"].read_bytes()


def test_cache_data_writes_the_jax_caches_and_csv(city_caches):
    root = city_caches["root"]
    assert len(city_caches["paths"]) == len(city_caches["jpaths"]) == CITY_SCENES
    rel = lambda ps, base: [str(p.relative_to(base)) for p in ps]  # noqa: E731
    assert rel(city_caches["paths"], root / "port") == rel(city_caches["jpaths"], root / "jax")
    csvs = []
    for side in ("port", "jax"):
        with open(root / side / "metadata" / "metric_cache_metadata_node_0.csv", newline="") as fp:
            csvs.append([row[0].replace(str(root / side), "<root>") for row in csv.reader(fp)])
    assert csvs[0] == csvs[1] and csvs[0][0] == "file_name" and len(csvs[0]) == CITY_SCENES + 1
    # the port's caches, read by JAX's loader, equal JAX's caches
    got, want = JMetricCacheLoader(root / "port"), JMetricCacheLoader(root / "jax")
    assert sorted(got.tokens) == sorted(want.tokens)
    for token in want.tokens:
        a, b = got.get_from_token(token), want.get_from_token(token)
        assert (a.token, a.log_name, a.route_lane_ids) == (b.token, b.log_name, b.route_lane_ids)
        for k in ("pdm_poses", "pdm_times", "initial_state", "centerline"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        for part in ("tracks", "drivable"):
            for k, v in vars(getattr(b, part)).items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(getattr(getattr(a, part), k), v, err_msg=f"{part}.{k}")
        assert a.drivable.valid.sum() > 10 and a.tracks.valid.sum() == 1


def test_metric_cache_processor_is_resumable(city_caches):
    path = city_caches["paths"][0]
    stamp = path.stat().st_mtime_ns
    assert city_caches["processor"].compute_metric_cache(city_caches["scene"]) == path
    assert path.stat().st_mtime_ns == stamp
    # and JAX's processor resumes from the port's cache
    assert JMetricCacheProcessor(str(city_caches["root"] / "port")).cache_file(city_caches["scene"]) == path


def test_cv_agent_on_the_port_caches_scores_as_jax(city_caches):
    """The constant-velocity agent scored on the port's caches (port loader,
    port scorer) against JAX's `batched_pdm_score` on the same files read by
    JAX: every sub-score within 1e-4."""
    root, loader = city_caches["root"], city_caches["loader"]
    caches = MetricCacheLoader(root / "port")
    jcaches = JMetricCacheLoader(root / "port")
    tokens = sorted(caches.tokens)
    trajs = [ConstantVelocityAgent().compute_trajectory(loader.get_agent_input_from_token(t)) for t in tokens]
    jtrajs = [JCVAgent().compute_trajectory(loader.get_agent_input_from_token(t)) for t in tokens]
    for a, b in zip(trajs, jtrajs):
        np.testing.assert_array_equal(a.poses, b.poses)
    got = batched_pdm_score([caches.get_from_token(t) for t in tokens], trajs, PDMSimulator(SAMPLING),
                            device="cpu")
    want = jax_batched_pdm_score([jcaches.get_from_token(t) for t in tokens], jtrajs, JSimulator(SAMPLING))
    for g, w in zip(got, want):
        for k, v in vars(w).items():
            assert abs(getattr(g, k) - v) <= TOL * max(1.0, abs(v)), (k, getattr(g, k), v)
