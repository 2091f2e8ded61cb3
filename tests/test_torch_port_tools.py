"""Parity of the port's host tools with the JAX package, on the CPU.

- The map converter (`planning/{gpkg,convert_maps}.py`) on the 10 cases of
  `tests/test_convert_maps.py`, each holding the port's function against
  JAX's on the same inputs: fids, baselines, the map objects with their
  lane and roadblock graphs, the WKB primitives and the rows of a real
  `.gpkg` built in the test (sqlite3) equal; the converted map gives the
  same route search; a port-written `.ddmap.pkl` loads in JAX's map API
  and a JAX-written one in the port's; the CLI writes what JAX's writes.
- The visualisation (`visualization/*`) on the 5 cases of
  `tests/test_visualization.py`: the drawn arrays (rendered frames, camera
  overlays, tiles, the BEV semantic raster), the patch and line counts and
  their vertices, and the projected camera points equal JAX's; not the
  image bytes.
- `BEVVisualizationCallback.on_validation_batch` writes JAX's file names,
  with equal pixel arrays read back; `DiffusionDriveAgent.
  get_training_callbacks` holds JAX's callback types, with and without
  `output_dir`.
- The soak (`script/run_soak.py`): its batch pool equal to JAX's bit for
  bit; a tiny CPU run (JAX's documented CPU smoke: 12 steps, a checkpoint
  every 6; at batch 4, not its 8) that ends `ok` with one row a step and
  restores; its checks firing on hand-made bad records.
"""

import dataclasses
import json
import sqlite3
import struct
import sys

import numpy as np
import pytest
import torch

import diffusiondrive_torch.planning.convert_maps as pconvert
import diffusiondrive_torch.planning.gpkg as pgpkg
import diffusiondrive_tpu.planning.convert_maps as jconvert
import diffusiondrive_tpu.planning.gpkg as jgpkg
from diffusiondrive_torch.common.dataclasses import SceneFilter, SensorConfig
from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.planning.map_api import LocalMapAPI, get_maps_api
from diffusiondrive_tpu.common.dataclasses import SceneFilter as JSceneFilter
from diffusiondrive_tpu.common.dataclasses import SensorConfig as JSensorConfig
from diffusiondrive_tpu.common.dataloader import SceneLoader as JSceneLoader
from diffusiondrive_tpu.planning.map_api import LocalMapAPI as JLocalMapAPI
from diffusiondrive_tpu.planning.map_api import get_maps_api as jax_get_maps_api

from test_convert_maps import _build_gpkg, _fixture_rows, _rect, gp_blob, wkb_linestring, wkb_multipolygon, wkb_polygon
from test_torch_port_planning import _objects_equal


def _geometry_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.type_name, a.part_slices) == (b.type_name, b.part_slices)
    assert len(a.parts) == len(b.parts)
    for x, y in zip(a.parts, b.parts):
        np.testing.assert_array_equal(x, y)


def _rows_equal(a, b):
    assert list(a) == list(b)
    for layer in a:
        assert len(a[layer]) == len(b[layer]), layer
        for x, y in zip(a[layer], b[layer]):
            assert list(x) == list(y), layer
            for k, v in y.items():
                if isinstance(v, np.ndarray) or v is None:
                    if v is None:
                        assert x[k] is None, (layer, k)
                    else:
                        np.testing.assert_array_equal(x[k], v, err_msg=f"{layer}.{k}")
                elif isinstance(v, float) and np.isnan(v):
                    assert np.isnan(x[k]), (layer, k)
                else:
                    assert x[k] == v and type(x[k]) is type(v), (layer, k)


# --------------------------------------------------------------------------- #
# The map converter: the 10 cases of tests/test_convert_maps.py
# --------------------------------------------------------------------------- #


def test_fid_normalization_equals_jax():
    for v in (101.0, 102, "201", float("nan"), None, 1.5, np.float64(7.0), np.int64(3)):
        assert pconvert._fid(v) == jconvert._fid(v), v
    assert pconvert._fid(101.0) == "101" and pconvert._fid(1.5) == "1.5" and pconvert._fid(float("nan")) is None


def test_baseline_heading_computation_equals_jax():
    for xy in (np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]), np.zeros((1, 2)), None,
               np.random.default_rng(0).normal(size=(9, 2))):
        got, want = pconvert.baseline_poses_from_coords(xy), jconvert.baseline_poses_from_coords(xy)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(pconvert.baseline_poses_from_coords(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]))[:, 2],
                               [0.0, np.pi / 2, np.pi / 2])


def test_build_map_objects_layers_and_attributes_equal_jax():
    api, japi = pconvert.build_map_objects(_fixture_rows(), "fixture"), jconvert.build_map_objects(_fixture_rows(), "fixture")
    assert isinstance(api, LocalMapAPI) and api.map_name == japi.map_name == "fixture"
    _objects_equal(api, japi)
    lane = api.get_map_object("101")
    assert (lane.parent_token, lane.speed_limit, lane.baseline.shape) == ("11", 13.4, (11, 3))
    assert api.get_map_object("102").speed_limit is None and api.get_map_object("102").baseline is None


def test_build_map_objects_lane_graph_equals_jax():
    api, japi = pconvert.build_map_objects(_fixture_rows()), jconvert.build_map_objects(_fixture_rows())
    for token in ("101", "201", "102"):
        assert api.get_map_object(token).outgoing == japi.get_map_object(token).outgoing
        assert api.get_map_object(token).incoming == japi.get_map_object(token).incoming
    assert api.get_map_object("101").outgoing == ["201"] and api.get_map_object("102").incoming == ["201"]


def test_build_map_objects_roadblock_graph_equals_jax():
    api, japi = pconvert.build_map_objects(_fixture_rows()), jconvert.build_map_objects(_fixture_rows())
    for token in ("11", "21", "12"):
        assert api.get_map_object(token).outgoing == japi.get_map_object(token).outgoing
        assert api.get_map_object(token).incoming == japi.get_map_object(token).incoming
        assert ([lane.token for lane in api.lanes_of_roadblock(token)]
                == [lane.token for lane in japi.lanes_of_roadblock(token)])
    assert api.get_map_object("21").outgoing == ["12"] and api.get_map_object("21").incoming == ["11"]


def test_converted_map_route_search_and_files_both_ways(tmp_path):
    """Saved by one package and loaded by the other, then the BFS route
    machinery of each on each."""
    from diffusiondrive_torch.planning.pdm_closed.graph_search import BreadthFirstSearchRoadBlock
    from diffusiondrive_tpu.planning.pdm_closed.graph_search import BreadthFirstSearchRoadBlock as JBFS

    pconvert.build_map_objects(_fixture_rows(), "fixture").save(tmp_path / "port" / "fixture.ddmap.pkl")
    jconvert.build_map_objects(_fixture_rows(), "fixture").save(tmp_path / "jax" / "fixture.ddmap.pkl")
    from_jax = get_maps_api(str(tmp_path / "jax"), "fixture")
    from_port = jax_get_maps_api(str(tmp_path / "port"), "fixture")
    assert isinstance(from_jax, LocalMapAPI) and isinstance(from_port, JLocalMapAPI)
    _objects_equal(from_jax, from_port)
    assert (tmp_path / "port" / "fixture.ddmap.pkl").read_bytes() == (tmp_path / "jax" / "fixture.ddmap.pkl").read_bytes()
    for api in (from_jax, LocalMapAPI.load(tmp_path / "port" / "fixture.ddmap.pkl")):
        assert BreadthFirstSearchRoadBlock(api, "11", forward=True).search(["12"], max_depth=5) == (
            ["11", "21", "12"], True)
    assert JBFS(from_port, "11", forward=True).search(["12"], max_depth=5) == (["11", "21", "12"], True)


def _blobs():
    """The WKB cases of `test_wkb_parser_primitives`, by name."""
    sq = _rect(0, 0, 2, 2)
    ext = bytearray(gp_blob(wkb_polygon([sq])))
    ext[3] |= 0x20
    pts = np.column_stack([sq, np.zeros(len(sq))])
    ewkb = struct.pack("<BI", 1, 0x20000000 | 0x80000000 | 3) + struct.pack("<I", 4326)
    ewkb += struct.pack("<I", 1) + struct.pack("<I", len(pts)) + pts.astype("<f8").tobytes()
    return {"polygon": gp_blob(wkb_polygon([sq])), "big_endian": gp_blob(wkb_polygon([sq], order=">")),
            "z": gp_blob(wkb_polygon([sq], ndim=3)), "envelope": gp_blob(wkb_polygon([sq]), envelope_xy=(0, 2, 0, 2)),
            "multipolygon": gp_blob(wkb_multipolygon([[_rect(50, 50, 51, 51)], [_rect(0, 0, 10, 10)]])),
            "linestring": gp_blob(wkb_linestring(np.array([[0.0, 0.0], [3.0, 4.0]]))),
            "null": None, "empty": gp_blob(b"", empty=True), "ewkb": gp_blob(ewkb), "extended": bytes(ext)}


def test_wkb_parser_primitives_equal_jax():
    for name, blob in _blobs().items():
        if name == "extended":
            for mod in (pgpkg, jgpkg):
                with pytest.raises(ValueError, match="Extended"):
                    mod.parse_gpkg_geometry(blob)
            continue
        got, want = pgpkg.parse_gpkg_geometry(blob), jgpkg.parse_gpkg_geometry(blob)
        _geometry_equal(got, want)
        for fn in ("exterior_ring", "line_coords"):
            a, b = getattr(pgpkg, fn)(got), getattr(jgpkg, fn)(want)
            assert (a is None) == (b is None), (name, fn)
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {fn}")
    np.testing.assert_array_equal(pgpkg.exterior_ring(pgpkg.parse_gpkg_geometry(_blobs()["multipolygon"])),
                                  _rect(0, 0, 10, 10))


def test_rows_from_real_gpkg_equal_jax(tmp_path):
    gpkg = tmp_path / "map.gpkg"
    _build_gpkg(gpkg)
    rows = pconvert.rows_from_gpkg(gpkg)
    _rows_equal(rows, jconvert.rows_from_gpkg(gpkg))
    crosswalks = {r["fid"]: r["polygon"] for r in rows["crosswalks"]}
    assert crosswalks[42] is None and crosswalks[43] is None and "generic_drivable_areas" not in rows
    with sqlite3.connect(gpkg) as conn:
        assert pgpkg.geometry_columns(conn) == jgpkg.geometry_columns(conn)


def test_convert_location_and_cli_from_gpkg_equal_jax(tmp_path, monkeypatch):
    """`convert_location` of both packages on the same GPKG, then the CLI
    of each on a nuplan-layout root: the same `.ddmap.pkl` bytes."""
    gpkg = tmp_path / "root" / "fixture-town" / "nuplan-maps-v1.0" / "map.gpkg"
    gpkg.parent.mkdir(parents=True)
    _build_gpkg(gpkg)
    api = pconvert.convert_location(gpkg, "fixture-town")
    _objects_equal(api, jconvert.convert_location(gpkg, "fixture-town"))
    np.testing.assert_array_equal(api.get_map_object("11").polygon, _fixture_rows()["lane_groups_polygons"][0]["polygon"])
    assert api.get_map_object("31").polygon.shape[1] == 2
    args = ["--nuplan-maps-root", str(tmp_path / "root"), "--locations", "fixture-town", "nowhere"]
    pconvert.main([*args, "--output-dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["convert_maps", *args, "--output-dir", str(tmp_path / "jax")])
    jconvert.main()
    assert [p.name for p in (tmp_path / "port").iterdir()] == ["fixture-town.ddmap.pkl"]
    assert ((tmp_path / "port" / "fixture-town.ddmap.pkl").read_bytes()
            == (tmp_path / "jax" / "fixture-town.ddmap.pkl").read_bytes())


def test_rows_missing_fields_are_skipped_as_in_jax():
    rows = {"lanes_polygons": [dict(fid=None, polygon=_rect(0, 0, 1, 1)), dict(fid=7, polygon=None),
                               dict(fid=8, lane_group_fid=None, polygon=_rect(0, 0, 1, 1))]}
    api, japi = pconvert.build_map_objects(rows), jconvert.build_map_objects(rows)
    _objects_equal(api, japi)
    assert api.get_map_object("7") is None and api.get_map_object("8").parent_token is None


# --------------------------------------------------------------------------- #
# The visualisation: the 5 cases of tests/test_visualization.py
# --------------------------------------------------------------------------- #


def _scenes(synthetic_log, sensors=False):
    """The same scene through the port's loader and JAX's."""
    logs_dir, blobs_dir = synthetic_log
    kwargs = dict(num_history_frames=4, num_future_frames=10, frame_interval=14)
    out = []
    for loader_cls, filt, sc in ((SceneLoader, SceneFilter, SensorConfig), (JSceneLoader, JSceneFilter, JSensorConfig)):
        sensor_config = sc.build_all_sensors(include=[3]) if sensors else sc.build_no_sensors()
        loader = loader_cls(logs_dir, blobs_dir, filt(**kwargs), sensor_config, build_map_api=False)
        out.append(loader.get_scene_from_token(loader.tokens[0]))
    return out


def _axes_equal(ax, jax_ax):
    """The same patches (vertices), lines (data) and images (arrays)."""
    assert len(ax.patches) == len(jax_ax.patches)
    for p, q in zip(ax.patches, jax_ax.patches):
        np.testing.assert_array_equal(p.get_xy(), q.get_xy())
        assert p.get_facecolor() == q.get_facecolor() and p.get_zorder() == q.get_zorder()
    assert len(ax.lines) == len(jax_ax.lines)
    for a, b in zip(ax.lines, jax_ax.lines):
        np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())
    assert len(ax.images) == len(jax_ax.images)
    for a, b in zip(ax.images, jax_ax.images):
        np.testing.assert_array_equal(a.get_array(), b.get_array())


def _calibrate(cam):
    """`test_visualization.py`'s forward-facing calibration."""
    cam.sensor2lidar_rotation = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
    cam.sensor2lidar_translation = np.array([1.5, 0.0, 1.6])
    cam.intrinsics = np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1]])
    return cam


def test_bev_plot_and_gif_equal_jax(synthetic_log, tmp_path):
    import matplotlib.pyplot as plt
    from PIL import Image

    import diffusiondrive_torch.visualization as pviz
    import diffusiondrive_tpu.visualization as jviz
    from diffusiondrive_torch.agents.constant_velocity_agent import ConstantVelocityAgent
    from diffusiondrive_tpu.agents.constant_velocity_agent import ConstantVelocityAgent as JConstantVelocityAgent

    scene, jscene = _scenes(synthetic_log)
    for plot, args, jargs in ((pviz.plot_bev_frame, (), ()),
                              (pviz.plot_bev_with_agent, (ConstantVelocityAgent(),), (JConstantVelocityAgent(),))):
        fig, ax = plot(scene, *args)
        jfig, jax_ax = getattr(jviz, plot.__name__)(jscene, *jargs)
        _axes_equal(ax, jax_ax)
        assert len(ax.patches) >= 2 and len(ax.lines) == (2 if args else 0)
        plt.close(fig)
        plt.close(jfig)
    for idx in (3, 4):
        np.testing.assert_array_equal(pviz.frame_plot_to_image(pviz.plot_bev_frame, scene, idx),
                                      jviz.frame_plot_to_image(jviz.plot_bev_frame, jscene, idx))
    pviz.frame_plot_to_gif(str(tmp_path / "port.gif"), pviz.plot_bev_frame, scene, frame_indices=[3, 4])
    jviz.frame_plot_to_gif(str(tmp_path / "jax.gif"), jviz.plot_bev_frame, jscene, frame_indices=[3, 4])
    with Image.open(tmp_path / "port.gif") as a, Image.open(tmp_path / "jax.gif") as b:
        assert a.n_frames == b.n_frames == 2
        for i in range(2):
            a.seek(i)
            b.seek(i)
            np.testing.assert_array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))


def test_bev_semantic_render_equals_jax():
    from diffusiondrive_torch.visualization import render_bev_semantic_map
    from diffusiondrive_tpu.visualization import render_bev_semantic_map as jrender

    raster = np.random.default_rng(1).integers(0, 8, size=(16, 32)).astype(np.int32)
    img = render_bev_semantic_map(raster)
    np.testing.assert_array_equal(img, jrender(raster))
    assert img.shape == (16, 32, 3) and img.dtype == np.uint8


def test_camera_projection_and_tiles_equal_jax(synthetic_log):
    import diffusiondrive_torch.visualization as pviz
    import diffusiondrive_tpu.visualization as jviz

    scene, jscene = _scenes(synthetic_log, sensors=True)
    frame, jframe = scene.frames[3], jscene.frames[3]
    cam, jcam = _calibrate(frame.cameras.cam_f0), _calibrate(jframe.cameras.cam_f0)
    rng = np.random.default_rng(2)
    pts = np.concatenate([[[10.0, 0.0, 1.6], [-5.0, 0.0, 1.6]], rng.uniform(-30, 30, (64, 3))])
    uv, ok = pviz.project_points_to_camera(pts, cam)
    juv, jok = jviz.project_points_to_camera(pts, jcam)
    np.testing.assert_array_equal(uv, juv)
    np.testing.assert_array_equal(ok, jok)
    assert ok[0] and not ok[1] and abs(uv[0, 0] - 960) < 1

    out = pviz.add_annotations_to_camera(cam.image, cam, frame.annotations.boxes, frame.annotations.names)
    np.testing.assert_array_equal(out, jviz.add_annotations_to_camera(jcam.image, jcam, jframe.annotations.boxes,
                                                                      jframe.annotations.names))
    assert (out != cam.image).any()
    np.testing.assert_array_equal(pviz.add_lidar_to_camera(cam.image, cam, frame.lidar),
                                  jviz.add_lidar_to_camera(jcam.image, jcam, jframe.lidar))
    np.testing.assert_array_equal(pviz.camera_tile(frame.cameras), jviz.camera_tile(jframe.cameras))


def test_camera_grid_plots_equal_jax(synthetic_log):
    import matplotlib.pyplot as plt

    import diffusiondrive_torch.visualization as pviz
    import diffusiondrive_tpu.visualization as jviz

    scene, jscene = _scenes(synthetic_log, sensors=True)
    for name in ("plot_cameras_frame", "plot_cameras_frame_with_lidar", "plot_cameras_frame_with_annotations"):
        fig, axes = getattr(pviz, name)(scene)
        jfig, jaxes = getattr(jviz, name)(jscene)
        assert axes.shape == jaxes.shape == (3, 3)
        for ax, jax_ax in zip(axes.flat, jaxes.flat):
            _axes_equal(ax, jax_ax)
        assert sum(len(ax.images) for ax in axes.flat) == 8 and len(axes[1][1].patches) >= 1
        plt.close(fig)
        plt.close(jfig)


def test_trajectory_camera_projection_equals_jax(synthetic_log):
    from diffusiondrive_torch.visualization import add_trajectory_to_camera
    from diffusiondrive_tpu.visualization import add_trajectory_to_camera as jadd

    scene, jscene = _scenes(synthetic_log, sensors=True)
    cam, jcam = _calibrate(scene.frames[3].cameras.cam_f0), _calibrate(jscene.frames[3].cameras.cam_f0)
    poses = np.stack([np.linspace(4, 20, 8), np.zeros(8), np.zeros(8)], -1)
    out = add_trajectory_to_camera(cam.image, cam, poses)
    np.testing.assert_array_equal(out, jadd(jcam.image, jcam, poses))
    assert (out != cam.image).any()


# --------------------------------------------------------------------------- #
# The training callback and the agent's callbacks
# --------------------------------------------------------------------------- #


def test_bev_visualization_callback_writes_what_jax_writes(tmp_path):
    from matplotlib.image import imread

    from diffusiondrive_torch.training.callbacks import BEVVisualizationCallback
    from diffusiondrive_tpu.training.callbacks import BEVVisualizationCallback as JCallback

    rng = np.random.default_rng(3)
    batch = {"bev_semantic_map": rng.integers(0, 7, (5, 16, 32)).astype(np.int64),
             "camera_feature": rng.uniform(-0.2, 1.2, (5, 16, 64, 3)).astype(np.float32)}
    outputs = {"bev_semantic_map": rng.normal(size=(5, 16, 32, 7)).astype(np.float32)}
    for cls, side in ((BEVVisualizationCallback, "port"), (JCallback, "jax")):
        cb = cls(str(tmp_path / side), max_samples=4)
        cb.on_validation_batch(2, batch, outputs)
        cb.on_validation_batch(2, batch, outputs, batch_idx=1)   # only the first batch draws
    names = sorted(p.name for p in (tmp_path / "port" / "epoch_0002").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "epoch_0002").iterdir())
    assert names == sorted([f"bev_semantic_{i}.png" for i in range(4)] + [f"camera_{i}.png" for i in range(4)])
    for name in names:
        np.testing.assert_array_equal(imread(tmp_path / "port" / "epoch_0002" / name),
                                      imread(tmp_path / "jax" / "epoch_0002" / name), err_msg=name)


def test_agent_training_callbacks_are_jaxs(tmp_path):
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_tpu.agents.diffusiondrive.agent import DiffusionDriveAgent as JAgent

    agent, jagent = DiffusionDriveAgent(device="cpu"), JAgent()
    for output_dir in (None, tmp_path / "run"):
        got = agent.get_training_callbacks(output_dir=output_dir)
        want = jagent.get_training_callbacks(output_dir=output_dir)
        assert [type(c).__name__ for c in got] == [type(c).__name__ for c in want]
        assert [getattr(c, "_output_dir", None) for c in got] == [getattr(c, "_output_dir", None) for c in want]
    assert [type(c).__name__ for c in got] == ["TimeLoggingCallback", "BEVVisualizationCallback"]
    assert got[1]._output_dir == tmp_path / "run" / "viz"


# --------------------------------------------------------------------------- #
# The soak
# --------------------------------------------------------------------------- #


def test_soak_batch_pool_equals_jax():
    from diffusiondrive_torch.script.run_soak import _make_batch_pool, tiny_soak_config
    from diffusiondrive_tpu.script.run_soak import _make_batch_pool as jpool

    from test_torch_port_model import _port_config

    from test_train import tiny_config

    jcfg = dataclasses.replace(tiny_config(), num_bounding_boxes=4)
    assert _port_config(jcfg) == dataclasses.replace(tiny_soak_config(), tf_d_model=256, tf_d_ffn=1024,
                                                     tf_num_layers=3, tf_num_head=8)
    got, want = _make_batch_pool(_port_config(jcfg), 3, 2, seed=5), jpool(jcfg, 3, 2, seed=5)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_soak_tiny_cpu_run_is_ok_and_restores(tmp_path):
    from diffusiondrive_torch.script.run_soak import main, profiled_steps

    assert profiled_steps(200, 50) == [4, 199] and profiled_steps(12, 6) == [4, 11]
    with pytest.raises(ValueError, match="multiple"):
        main(["--device", "cpu", "--tiny", "--steps", "10", "--checkpoint-every", "6"])
    out = tmp_path / "soak"
    assert main(["--device", "cpu", "--tiny", "--steps", "12", "--checkpoint-every", "6", "--batch", "4",
                 "--output-dir", str(out)]) == 0
    summary = json.loads((out / "soak_summary.json").read_text())
    assert summary["ok"] and not summary["failures"], summary
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 13))
    assert summary["checkpoints"] == ["epoch_0000", "epoch_0001"] and len(summary["epoch_walls_s"]) == 2
    assert summary["loss_last_k"] < summary["loss_first_k"]
    # on the CPU no kernel launches and nothing is profiled
    assert summary["epoch_launches"] == [{k: 0 for k in summary["epoch_launches"][0]}] * 2
    assert summary["compile_cache_size"] is None and summary["memory_end_bytes"] is None
    assert summary["device"] == "cpu"


def _good_record(steps=100, epochs=2):
    rows = [{"split": "train", "epoch": (s - 1) * epochs // steps, "step": s, "loss": 100.0 - 0.5 * s,
             "trajectory_loss": 1.0} for s in range(1, steps + 1)]
    return dict(rows=rows, steps=steps, epoch_walls=[9.0] + [5.0] * (epochs - 1), time_tol=0.35,
                epoch_launches=[{"lap": steps // epochs, "stem": 0}] * epochs,
                step_profiles=[{"kernels": 7000, "htod_copies": 0}] * 2,
                memory=[{"end_bytes": 3 << 30, "peak_bytes": 5 << 30}] * epochs,
                ckpts=[f"epoch_{e:04d}" for e in range(epochs)], num_epochs=epochs, lap_per_step=1)


@pytest.mark.parametrize("fault, message", [
    (None, None),
    ("gap", "not contiguous"),
    ("rising", "loss did not decrease"),
    ("window", "loss window regressed"),
    ("nonfinite", "non-finite"),
    ("unstable", "deviates"),
    ("launches", "kernel launches differ"),
    ("lap", "LAP launches"),
    ("step_kernels", "kernels of a step changed"),
    ("memory_end", "allocated memory"),
    ("memory_peak", "peak"),
    ("checkpoints", "checkpoints"),
])
def test_soak_checks_fire_on_bad_records(fault, message):
    from diffusiondrive_torch.script.run_soak import soak_failures

    r = _good_record(epochs=5 if fault in ("unstable", "memory_end", "memory_peak") else 2)
    if fault == "gap":
        r["rows"] = r["rows"][:40] + r["rows"][41:] + [dict(r["rows"][-1], step=101)]
    elif fault == "rising":
        r["rows"] = [dict(row, loss=50.0 + row["step"]) for row in r["rows"]]
    elif fault == "window":
        r["rows"] = [dict(row, loss=100.0 - row["step"] + (30.0 if 60 < row["step"] <= 80 else 0.0))
                     for row in r["rows"]]
    elif fault == "nonfinite":
        r["rows"][7]["trajectory_loss"] = float("nan")
    elif fault == "unstable":
        r["epoch_walls"][3] = 9.0
    elif fault == "launches":
        r["epoch_launches"] = [r["epoch_launches"][0], {"lap": 50, "stem": 2}]   # a kernel launched in one epoch only
    elif fault == "lap":
        r["epoch_launches"] = [{"lap": 49, "stem": 0}] * 2
    elif fault == "step_kernels":
        r["step_profiles"] = [{"kernels": 7000, "htod_copies": 0}, {"kernels": 7002, "htod_copies": 0}]
    elif fault == "memory_end":
        r["memory"] = r["memory"][:3] + [{"end_bytes": (3 << 30) + (2 << 20), "peak_bytes": 5 << 30}] + r["memory"][4:]
    elif fault == "memory_peak":
        r["memory"] = r["memory"][:4] + [{"end_bytes": 3 << 30, "peak_bytes": int((5 << 30) * 1.02)}]
    elif fault == "checkpoints":
        r["ckpts"] = r["ckpts"][:1]
    failures, facts = soak_failures(**r)
    if fault is None:
        assert failures == [] and facts["last_k"] < facts["first_k"]
    else:
        assert failures and message in failures[0], failures
