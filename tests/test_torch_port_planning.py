"""Parity of the port's host planning pieces and nuScenes metrics with the JAX
package on the CPU: the map API on the 1440-object city grid of
`tests/test_map_scale.py` and its `.ddmap.pkl` files both ways, the route
correction on the scenarios of `tests/test_route_correction.py`, the numpy
geometry, path, IDM and graph search, the observation builders on the
synthetic scene, the emergency brake, and `evaluate/nuscenes_metrics.py`
(the inputs of `tests/test_nuscenes_metrics.py` and a seeded random batch)
elementwise in float32 and float64.

The host pieces are copies: they must equal JAX's bit for bit. The metrics
are torch ports of jnp functions: within 1e-4 x max(1, |JAX|) in float32 and
1e-10 in float64, the collision flags equal.
"""

import copy
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusiondrive_torch.common.dataclasses as port_dataclasses
import diffusiondrive_torch.planning.pdm_closed.np_geometry as geometry
import diffusiondrive_tpu.planning.pdm_closed.np_geometry as jgeometry
from diffusiondrive_torch.common.dataclasses import SceneFilter, SensorConfig, TrajectorySampling
from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.common.geometry import StateSE2
from diffusiondrive_torch.evaluate import nuscenes_metrics
from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData, get_maps_api
from diffusiondrive_torch.planning.pdm_closed import observation_builder, route_correction
from diffusiondrive_torch.planning.pdm_closed.emergency_brake import PDMEmergencyBrake
from diffusiondrive_torch.planning.pdm_closed.graph_search import BreadthFirstSearchRoadBlock, Dijkstra
from diffusiondrive_torch.planning.pdm_closed.idm import BatchIDMPolicy
from diffusiondrive_torch.planning.pdm_closed.pdm_path import PDMPath
from diffusiondrive_tpu.common.dataclasses import SceneFilter as JSceneFilter
from diffusiondrive_tpu.common.dataclasses import SensorConfig as JSensorConfig
from diffusiondrive_tpu.common.dataloader import SceneLoader as JSceneLoader
from diffusiondrive_tpu.common.geometry import StateSE2 as JStateSE2
from diffusiondrive_tpu.evaluate import nuscenes_metrics as jnuscenes_metrics
from diffusiondrive_tpu.evaluate.observation import MapLayer
from diffusiondrive_tpu.planning.map_api import LocalMapAPI as JLocalMapAPI
from diffusiondrive_tpu.planning.map_api import MapObjectData as JMapObjectData
from diffusiondrive_tpu.planning.map_api import get_maps_api as jax_get_maps_api
from diffusiondrive_tpu.planning.pdm_closed import observation_builder as jobservation_builder
from diffusiondrive_tpu.planning.pdm_closed import route_correction as jroute_correction
from diffusiondrive_tpu.planning.pdm_closed.emergency_brake import PDMEmergencyBrake as JPDMEmergencyBrake
from diffusiondrive_tpu.planning.pdm_closed.graph_search import BreadthFirstSearchRoadBlock as JBFS
from diffusiondrive_tpu.planning.pdm_closed.graph_search import Dijkstra as JDijkstra
from diffusiondrive_tpu.planning.pdm_closed.idm import BatchIDMPolicy as JBatchIDMPolicy
from diffusiondrive_tpu.planning.pdm_closed.pdm_path import PDMPath as JPDMPath
from diffusiondrive_tpu.utils.synthetic import make_straight_map

from test_map_scale import make_city_map
from test_route_correction import _chain_map, _ego, _rect
from test_torch_port_pdm_closed import to_port_map

SAMPLING = TrajectorySampling(num_poses=40, interval_length=0.1)
TRAJ_SAMPLING = TrajectorySampling(num_poses=50, interval_length=0.1)
LAYERS = [MapLayer.ROADBLOCK, MapLayer.ROADBLOCK_CONNECTOR, MapLayer.INTERSECTION, MapLayer.LANE,
          MapLayer.LANE_CONNECTOR, MapLayer.CROSSWALK, MapLayer.WALKWAYS]


@pytest.fixture(scope="module")
def city():
    jmap = make_city_map()
    return to_port_map(jmap), jmap


def _objects_equal(a, b):
    assert len(a._objects) == len(b._objects)
    for x, y in zip(a._objects, b._objects):
        for k, v in vars(y).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(x, k), v, err_msg=f"{y.token}.{k}")
            else:
                assert getattr(x, k) == v, (y.token, k)


# --------------------------------------------------------------------------- #
# Map API
# --------------------------------------------------------------------------- #


def test_map_queries_on_the_city_grid_equal_jax(city):
    api, japi = city
    assert len(api._objects) == 1440
    rng = np.random.default_rng(0)
    points = np.concatenate([[[125.0, 0.0], [125.0, 9.0], [0.0, 0.0], [1199.0, 330.0]],
                             rng.uniform([-50, -50], [1250, 380], (24, 2))])
    for p in points:
        got = api.get_proximal_map_objects(p, 100.0, LAYERS)
        want = japi.get_proximal_map_objects(p, 100.0, LAYERS)
        assert {k: [o.token for o in v] for k, v in got.items()} == {k: [o.token for o in v] for k, v in want.items()}
        for layer in LAYERS:
            assert api.get_distance_to_nearest_map_object(p, layer) == japi.get_distance_to_nearest_map_object(p, layer)
    assert api.get_distance_to_nearest_map_object((125.0, 9.0), MapLayer.LANE) == ("lane_0_2", 5.0)
    assert [o.token for o in api.lanes_of_roadblock("rb_3_7")] == ["lane_3_7"]
    route = [f"lane_0_{i}" for i in range(24)]
    got, ok = Dijkstra(api, api.get_map_object("lane_0_1"), route).search("rb_0_9")
    want, jok = JDijkstra(japi, japi.get_map_object("lane_0_1"), route).search("rb_0_9")
    assert ok == jok and [o.token for o in got] == [o.token for o in want] and len(got) == 9
    for forward, start, targets in ((True, "rb_1_2", ["rb_1_20"]), (False, "rb_2_9", ["rb_2_3", "rb_2_4"]),
                                    (True, "rb_2_9", ["rb_2_3"])):
        got = BreadthFirstSearchRoadBlock(api, start, forward).search(targets)
        assert got == JBFS(japi, start, forward).search(targets)
        assert got[1] == (start != "rb_2_9" or not forward)


def test_ddmap_files_load_both_ways(city, tmp_path):
    api, japi = city
    japi.save(tmp_path / "jax" / "city.ddmap.pkl")
    api.save(tmp_path / "port" / "city.ddmap.pkl")
    # plain dicts and numpy arrays, no class of either package
    for side in ("jax", "port"):
        with open(tmp_path / side / "city.ddmap.pkl", "rb") as fp:
            payload = pickle.load(fp)
        assert all(type(o) is dict for o in payload["objects"])
    from_jax = get_maps_api(str(tmp_path / "jax"), "city")
    from_port = jax_get_maps_api(str(tmp_path / "port"), "city")
    assert isinstance(from_jax, LocalMapAPI) and isinstance(from_port, JLocalMapAPI)
    assert from_jax.map_name == from_port.map_name == "city"
    _objects_equal(from_jax, japi)
    _objects_equal(from_port, api)
    assert get_maps_api(str(tmp_path / "jax"), "elsewhere") is None and get_maps_api(None, "city") is None


def test_corrupt_map_file_raises_where_jax_hides_it(tmp_path, monkeypatch, synthetic_log):
    """The port raises for a map file that does not load (JAX's scene loader
    returns None and the scene would plan without its map)."""
    (tmp_path / "us-ma-boston.ddmap.pkl").write_bytes(b"not a pickle")
    with pytest.raises(pickle.UnpicklingError):
        get_maps_api(str(tmp_path), "us-ma-boston")
    monkeypatch.setattr(port_dataclasses, "NUPLAN_MAPS_ROOT", str(tmp_path))
    logs_dir, blobs_dir = synthetic_log
    loader = SceneLoader(logs_dir, blobs_dir, SceneFilter(num_history_frames=4, num_future_frames=10,
                                                          frame_interval=1))
    with pytest.raises(pickle.UnpicklingError):
        loader.get_scene_from_token(loader.tokens[0])
    import diffusiondrive_tpu.common.dataclasses as jax_dataclasses

    monkeypatch.setattr(jax_dataclasses, "NUPLAN_MAPS_ROOT", str(tmp_path))
    assert jax_dataclasses.Scene._build_map_api("us-ma-boston") is None


# --------------------------------------------------------------------------- #
# Route correction (the scenarios of tests/test_route_correction.py)
# --------------------------------------------------------------------------- #


def _branch_map():
    jmap = _chain_map()
    objs = list(jmap._objects)
    objs.append(JMapObjectData(token="sb", layer=MapLayer.ROADBLOCK, polygon=_rect(50, -20, 100, -12),
                               outgoing=["rb2"], incoming=[]))
    bx = np.arange(50.0, 101.0, 2.0)
    objs.append(JMapObjectData(token="sblane", layer=MapLayer.LANE, polygon=_rect(50, -20, 100, -12),
                               baseline=np.stack([bx, np.full_like(bx, -16.0), np.zeros_like(bx)], -1),
                               parent_token="sb", outgoing=["lane2"], incoming=[]))
    return JLocalMapAPI(objs, "branch")


def _loop_map():
    return JLocalMapAPI([
        JMapObjectData(token="a", layer=MapLayer.ROADBLOCK, polygon=_rect(0, -4, 50, 4)),
        JMapObjectData(token="c1", layer=MapLayer.ROADBLOCK_CONNECTOR, polygon=_rect(50, -4, 60, 4)),
        JMapObjectData(token="b", layer=MapLayer.ROADBLOCK, polygon=_rect(60, -4, 110, 4)),
        JMapObjectData(token="c2", layer=MapLayer.ROADBLOCK_CONNECTOR, polygon=_rect(52, -4, 62, 4)),
        JMapObjectData(token="d", layer=MapLayer.ROADBLOCK, polygon=_rect(0, 4, 50, 12)),
    ], "loop")


# name -> (JAX map, ego, route ids, the corrected ids JAX's tests expect)
CORRECTIONS = {
    "on_route_start": (_chain_map, _ego(130.0), ["rb2", "rb3", "rb4"], ["rb2", "rb3", "rb4"]),
    "behind_start": (_chain_map, _ego(30.0), ["rb2", "rb3"], ["rb0", "rb1", "rb2", "rb3"]),
    "ahead_of_route": (_chain_map, _ego(230.0), ["rb0", "rb1", "rb2"], ["rb0", "rb1", "rb2"]),
    "forward_reconnection": (_branch_map, _ego(75.0, y=-16.0), ["rb0", "rb1", "rb2", "rb3"], ["sb", "rb2", "rb3"]),
    "gap": (_chain_map, _ego(30.0), ["rb0", "rb3", "rb4"], ["rb0", "rb1", "rb2", "rb3", "rb4"]),
    "gaps": (lambda: _chain_map(num_blocks=8), _ego(30.0), ["rb0", "rb2", "rb4", "rb6"],
             ["rb0", "rb1", "rb2", "rb3", "rb4", "rb5", "rb6"]),
}
CANDIDATES = [(_ego(150.0), ["rb3", "rb4"]), (_ego(130.0, y=1.0), ["rb5"]), (_ego(130.0, heading=np.pi), ["rb2"]),
              (_ego(130.0, y=40.0), ["rb2"])]


@pytest.mark.parametrize("name", list(CORRECTIONS))
def test_route_correction_equals_jax(name):
    make, ego, ids, expected = CORRECTIONS[name]
    jmap = make()
    api = to_port_map(jmap)
    got = route_correction.route_roadblock_correction(ego, api, {t: api.get_map_object(t) for t in ids})
    want = jroute_correction.route_roadblock_correction(ego, jmap, {t: jmap.get_map_object(t) for t in ids})
    assert got == want == expected


def test_route_candidates_and_loops_equal_jax():
    jmap = _chain_map()
    api = to_port_map(jmap)
    for ego, ids in CANDIDATES:
        best, cands = route_correction.get_current_roadblock_candidates(
            ego, api, {t: api.get_map_object(t) for t in ids})
        jbest, jcands = jroute_correction.get_current_roadblock_candidates(
            ego, jmap, {t: jmap.get_map_object(t) for t in ids})
        assert best.token == jbest.token and [c.token for c in cands] == [c.token for c in jcands]
    for jm, ids, expected in ((_loop_map(), ["a", "c1", "b", "c2", "d"], ["a", "c1", "b"]),
                              (_chain_map(connector_idx=(1, 3)), [f"rb{i}" for i in range(5)],
                               [f"rb{i}" for i in range(5)])):
        assert route_correction.remove_route_loops(ids, to_port_map(jm)) == expected
        assert jroute_correction.remove_route_loops(ids, jm) == expected


# --------------------------------------------------------------------------- #
# numpy geometry, path, IDM, emergency brake: bit for bit
# --------------------------------------------------------------------------- #


def _rings(rng, n):
    """Seeded rings: convex boxes, star-shaped non-convex polygons, slivers."""
    out = []
    for i in range(n):
        c = rng.uniform(-10, 10, 2)
        if i % 3 == 0:
            w, h = rng.uniform(0.5, 6, 2)
            out.append(_rect(c[0] - w, c[1] - h, c[0] + w, c[1] + h))
        else:
            k = 5 + i % 7
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(1.0, 6.0, k) if i % 3 == 1 else rng.uniform(0.05, 0.3, k) * 10
            out.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1))
    return out


def test_np_geometry_is_bit_for_bit_jax():
    rng = np.random.default_rng(3)
    rings = _rings(rng, 12)
    points = rng.uniform(-15, 15, (64, 2))
    polylines = [np.cumsum(rng.uniform(-2, 3, (6, 2)), 0) + rng.uniform(-10, 10, 2) for _ in range(6)]
    for a in rings:
        np.testing.assert_array_equal(geometry.point_in_polygon(points, a), jgeometry.point_in_polygon(points, a))
        for b in rings:
            assert geometry.polygon_distance(a, b) == jgeometry.polygon_distance(a, b)
            assert geometry.polygon_intersection_area(a, b) == jgeometry.polygon_intersection_area(a, b)
            assert (geometry.polygon_intersection_area(a, b, resolution=17)
                    == jgeometry.polygon_intersection_area(a, b, resolution=17))
        for line in polylines:
            assert geometry.polyline_polygon_distance(line, a) == jgeometry.polyline_polygon_distance(line, a)
            for hw in (0.5, 1.1485):
                assert (geometry.corridor_intersects_polygon(line, hw, a)
                        == jgeometry.corridor_intersects_polygon(line, hw, a))
    assert geometry.polygon_intersection_area(_rect(0, 0, 10, 10), _rect(5, 5, 15, 15)) == pytest.approx(25.0, rel=0.05)


def test_path_idm_and_emergency_brake_are_bit_for_bit_jax():
    theta = np.linspace(-np.pi / 2, 0.3, 40)
    poses = np.stack([50 * np.cos(theta), 50 + 50 * np.sin(theta), theta + np.pi / 2], -1)
    path, jpath = PDMPath([StateSE2(*p) for p in poses]), JPDMPath([JStateSE2(*p) for p in poses])
    rng = np.random.default_rng(4)
    pts = rng.uniform(-10, 60, (50, 2))
    np.testing.assert_array_equal(path.project(pts), jpath.project(pts))
    d = np.linspace(-5, path.length + 5, 77)
    np.testing.assert_array_equal(path.interpolate(d), jpath.interpolate(d))
    np.testing.assert_array_equal(path.substring(3.3, 41.7), jpath.substring(3.3, 41.7))

    idm, jidm = BatchIDMPolicy(), JBatchIDMPolicy()
    idm.update(12.5)
    jidm.update(12.5)
    states = np.stack([rng.uniform(0, 20, 5), rng.uniform(0, 15, 5)], -1)
    leading = np.stack([states[:, 0] + rng.uniform(0.5, 30, 5), rng.uniform(0, 10, 5), rng.uniform(0, 3, 5)], -1)
    np.testing.assert_array_equal(idm.propagate(states, leading, list(range(5)), 0.1),
                                  jidm.propagate(states, leading, list(range(5)), 0.1))

    brake, jbrake = PDMEmergencyBrake(), JPDMEmergencyBrake()
    for ttc in ((1.5, np.inf), (np.inf, np.inf), (2.0, 3.0), (np.inf, 1.99)):
        assert brake.should_brake(*ttc) == jbrake.should_brake(*ttc)
    for v0, heading in ((8.1, 0.0), (0.0, 1.0), (13.7, -2.5)):
        state = np.zeros(11)
        state[:3] = (3.0, -4.0, heading)
        state[3] = v0
        np.testing.assert_array_equal(brake.brake_trajectory(state), jbrake.brake_trajectory(state))
    state = np.zeros(11)
    state[3] = 8.1
    assert brake.brake_trajectory(state)[-1, 0] == pytest.approx(8.1 ** 2 / (2 * 4.05), abs=0.05)


# --------------------------------------------------------------------------- #
# Observation builders on the synthetic scene
# --------------------------------------------------------------------------- #


def _arrays_equal(got, want, what):
    for k, v in vars(want).items():
        if v is None:
            assert getattr(got, k) is None, k
        else:
            np.testing.assert_array_equal(getattr(got, k), v, err_msg=f"{what}.{k}")
            assert getattr(got, k).dtype == v.dtype, (what, k)


def test_observation_builders_equal_jax(synthetic_log, city):
    logs_dir, blobs_dir = synthetic_log
    kwargs = dict(num_history_frames=4, num_future_frames=10, frame_interval=1)
    scene = SceneLoader(logs_dir, blobs_dir, SceneFilter(**kwargs), SensorConfig.build_no_sensors(),
                        build_map_api=False).get_scene_from_token("token_003")
    jscene = JSceneLoader(logs_dir, blobs_dir, JSceneFilter(**kwargs), JSensorConfig.build_no_sensors(),
                          build_map_api=False).get_scene_from_token("token_003")
    jmap = make_straight_map()
    jmap.get_map_object("lane1").layer = MapLayer.LANE_CONNECTOR
    jmap = JLocalMapAPI(jmap._objects, "synthetic")
    api = to_port_map(jmap)
    route = ["lane1", "lane2"]
    for red in (False, True):
        scene, jscene = copy.deepcopy(scene), copy.deepcopy(jscene)
        for s in (scene, jscene):
            s.frames[3].traffic_lights = [("lane1", red)]
        got = observation_builder.build_planner_observation(scene, route, api, SAMPLING, TRAJ_SAMPLING)
        want = jobservation_builder.build_planner_observation(jscene, route, jmap, SAMPLING, TRAJ_SAMPLING)
        _arrays_equal(got, want, f"planner observation red={red}")
        assert got.valid.sum() == 1 + red and got.poses.shape == (26, 96, 3)
        assert (got.rings_override is not None) == red
    _arrays_equal(observation_builder.build_gt_observation(scene, SAMPLING, TRAJ_SAMPLING),
                  jobservation_builder.build_gt_observation(jscene, SAMPLING, TRAJ_SAMPLING), "gt observation")
    np.testing.assert_array_equal(observation_builder.ego_state_array_from_scene(scene),
                                  jobservation_builder.ego_state_array_from_scene(jscene))
    api, japi = city
    for pose in ((125.0, 0.0, 0.0), (600.0, 150.0, 0.3), (-400.0, 0.0, 0.0)):
        route = [f"lane_0_{i}" for i in range(6)]
        got = observation_builder.build_drivable_area_map(api, pose, route)
        _arrays_equal(got, jobservation_builder.build_drivable_area_map(japi, pose, route), "drivable map")
        assert got.polygons.shape == (256, 48, 2)
    assert observation_builder.build_drivable_area_map(None, (0.0, 0.0, 0.0), []).valid.sum() == 0


# --------------------------------------------------------------------------- #
# nuScenes metrics (torch ports of jnp functions)
# --------------------------------------------------------------------------- #


def _metric_inputs():
    """The inputs of tests/test_nuscenes_metrics.py, then a seeded batch."""
    T, O = 6, 2
    gt = np.zeros((2, T, 3))
    gt[:, :, 0] = np.arange(1, T + 1) * 2.0
    pred = gt.copy()
    pred[1, :, 1] += 1.0
    boxes = np.zeros((2, T, O, 5))
    valid = np.zeros((2, T, O), bool)
    boxes[0, :, 0] = [4.0, 0.0, 0.0, 4.0, 2.0]
    boxes[1, :, 0] = [100.0, 0.0, 0.0, 4.0, 2.0]
    valid[:, :, 0] = True
    yield "jax_test", pred, gt, boxes, valid
    rng = np.random.default_rng(7)
    B, O = 16, 8
    pred = np.cumsum(np.stack([rng.uniform(0, 4, (B, T)), rng.normal(0, 0.4, (B, T)), rng.normal(0, 0.05, (B, T))],
                              -1), axis=1)
    gt = pred + rng.normal(0, 0.7, pred.shape)
    boxes = np.concatenate([rng.uniform(-2, 40, (B, T, O, 1)), rng.uniform(-12, 12, (B, T, O, 1)),
                            rng.uniform(-np.pi, np.pi, (B, T, O, 1)), rng.uniform(2, 6, (B, T, O, 1)),
                            rng.uniform(1, 2.5, (B, T, O, 1))], -1)
    valid = rng.uniform(size=(B, T, O)) < 0.3
    yield "seeded", pred, gt, boxes, valid


def _tol(key, dtype):
    return 1e-4 if dtype == np.float32 or key.startswith("collision") else 1e-10


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nuscenes_metrics_match_jax_elementwise(dtype, monkeypatch):
    """JAX's functions run under `jax.jit` (its eager polygon test compiles
    op by op, seconds a shape); `evaluate_nuscenes` reaches the jitted ones.
    The l2 values hold the dtype's tolerance; the collision rates are
    float32 in both packages whatever the input (JAX casts them), so they
    hold float32's."""
    monkeypatch.setattr(jnuscenes_metrics, "l2_displacement", jax.jit(
        jnuscenes_metrics.l2_displacement, static_argnames=("horizons_s", "interval_s", "st_p3_average")))
    monkeypatch.setattr(jnuscenes_metrics, "collision_rate", jax.jit(
        jnuscenes_metrics.collision_rate, static_argnames=("horizons_s", "interval_s")))
    for name, pred, gt, boxes, valid in _metric_inputs():
        pred, gt, boxes = pred.astype(dtype), gt.astype(dtype), boxes.astype(dtype)
        with jax.enable_x64(dtype == np.float64):
            want = {}
            for avg in (True, False):
                want.update({f"{k} {avg}": np.asarray(v) for k, v in jnuscenes_metrics.l2_displacement(
                    jnp.asarray(pred), jnp.asarray(gt), st_p3_average=avg).items()})
            want.update({k: np.asarray(v) for k, v in jnuscenes_metrics.collision_rate(
                jnp.asarray(pred), jnp.asarray(boxes), jnp.asarray(valid)).items()})
            want_all = jnuscenes_metrics.evaluate_nuscenes(pred, gt, boxes, valid)
        got = {}
        for avg in (True, False):
            got.update({f"{k} {avg}": v.numpy() for k, v in nuscenes_metrics.l2_displacement(
                torch.from_numpy(pred), torch.from_numpy(gt), st_p3_average=avg).items()})
        got.update({k: v.numpy() for k, v in nuscenes_metrics.collision_rate(
            torch.from_numpy(pred), torch.from_numpy(boxes), torch.from_numpy(valid)).items()})
        got_all = nuscenes_metrics.evaluate_nuscenes(pred, gt, boxes, valid, device="cpu")
        assert got.keys() == want.keys() and got_all.keys() == want_all.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, (name, k)
            if k.startswith("collision_") and k != "collision_avg":
                np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")
            else:
                err = np.abs(got[k].astype(np.float64) - v).max()
                assert err <= _tol(k, dtype) * max(1.0, np.abs(v).max()), (name, k, err)
        for k, v in want_all.items():
            assert abs(got_all[k] - v) <= _tol(k, dtype) * max(1.0, abs(v)), (name, k, got_all[k], v)
        if name == "jax_test":
            np.testing.assert_allclose(got["l2_avg True"], [0.0, 1.0], atol=1e-6)
            assert got["collision_1s"][0] == 1.0 and got["collision_3s"].tolist() == [1.0, 0.0]
        else:   # the seeded batch hits and misses
            assert 0.0 < got["collision_3s"].mean() < 1.0


def test_nuscenes_metrics_run_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    _, pred, gt, boxes, valid = next(_metric_inputs())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nuscenes_metrics.evaluate_nuscenes(pred, gt, boxes, valid)
