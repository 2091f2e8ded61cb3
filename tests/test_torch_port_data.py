"""Parity of the port's dataset slice with the JAX package, on the CPU.

LZF (the port's native library and its pure-Python decoder) against JAX's
`native.lzf_decompress` and `common.dataclasses._lzf_decompress`, byte for
byte, on the streams of `tests/test_native.py` and on greedy LZF streams
with back references; the native `histogram2d`; `load_pcd` in ascii,
binary and binary_compressed, bit for bit; the sensors that
`SceneLoader.get_agent_input_from_token` reads from `synthetic_log`; and
the scene-backed `Dataset` (its cache files equal to JAX's once loaded,
resumable, `force_cache_computation`, uncached items equal to cached ones)
with the host, raw-sensor and target builders at `tiny_config`.
"""

import struct

import numpy as np
import pytest

import diffusiondrive_torch.common.dataclasses as pdc
import diffusiondrive_torch.native as pnative
import diffusiondrive_torch.training.dataset as pds
import diffusiondrive_tpu.common.dataclasses as jdc
import diffusiondrive_tpu.native as jnative
import diffusiondrive_tpu.training.dataset as jds
from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_tpu.common.dataloader import SceneLoader as JSceneLoader

from test_native import lzf_compress_reference
from test_torch_port_model import _port_config
from test_train import tiny_config

FIELDS = "x y z intensity ring lidar_id".split()


def lzf_compress_greedy(data: bytes) -> bytes:
    """A greedy LZF compressor with back references (3-byte hash of the
    last position, offsets < 8192, lengths up to 264; overlapping matches)."""
    out, lit, last = bytearray(), bytearray(), {}
    i, n = 0, len(data)

    def flush():
        for k in range(0, len(lit), 32):
            chunk = lit[k:k + 32]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()

    while i < n:
        key = data[i:i + 3]
        ref = last.get(key) if len(key) == 3 else None
        if len(key) == 3:
            last[key] = i
        if ref is not None and i - ref - 1 < 8192:
            length, top = 3, min(n - i, 264)
            while length < top and data[ref + length] == data[i + length]:
                length += 1
            flush()
            off, code = i - ref - 1, length - 2
            if code < 7:
                out.append((code << 5) | (off >> 8))
            else:
                out += bytes([(7 << 5) | (off >> 8), code - 7])
            out.append(off & 0xFF)
            i += length
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _streams():
    rng = np.random.default_rng(3)
    runs = np.repeat(rng.integers(0, 4, 400, dtype=np.uint8), rng.integers(1, 40, 400)).tobytes()
    floats = np.round(rng.normal(0, 5, 3000), 1).astype(np.float32).tobytes()
    literal = bytes(range(256)) * 10
    return {
        "literals": (lzf_compress_reference(literal), literal),
        "overlapping_back_reference": (bytes([5]) + b"abcabc" + bytes([(3 << 5) | 0, 2]), b"abcabcabcab"),
        "greedy_runs": (lzf_compress_greedy(runs), runs),
        "greedy_floats": (lzf_compress_greedy(floats), floats),
        "empty": (b"", b""),
    }


@pytest.mark.parametrize("case", sorted(_streams()))
def test_lzf_native_and_python_decoders_match_jax(case, monkeypatch):
    stream, plain = _streams()[case]
    assert pnative.get_native() is not None and jnative.get_native() is not None
    native = pnative.lzf_decompress(stream, len(plain))
    via_loader = pdc._lzf_decompress(stream, len(plain))
    python = pdc._lzf_decompress_python(stream, len(plain))
    monkeypatch.setattr(pnative, "lzf_decompress", lambda data, size: None)   # as without a compiler
    fallback = pdc._lzf_decompress(stream, len(plain))
    assert native == via_loader == python == fallback == plain
    assert native == jnative.lzf_decompress(stream, len(plain)) == jdc._lzf_decompress(stream, len(plain))


def test_lzf_native_rejects_a_corrupt_stream():
    with pytest.raises(ValueError, match="corrupt"):
        pnative.lzf_decompress(bytes([(1 << 5), 9]), 8)   # a reference before the start


def test_native_histogram2d_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-35, 35, 50000).astype(np.float32)
    y = rng.uniform(-35, 35, 50000).astype(np.float32)
    x[:3], y[:3] = (32.0, -32.0, 0.0), (32.0, 5.0, -32.0)   # both closed edges
    got = pnative.histogram2d(x, y, -32, 32, -32, 32, 256)
    assert got.dtype == np.uint32 and got.shape == (256, 256)
    np.testing.assert_array_equal(got, jnative.histogram2d(x, y, -32, 32, -32, 32, 256))


def _write_pcd(path, points, mode):
    n = points.shape[1]
    header = (f"VERSION 0.7\nFIELDS {' '.join(FIELDS)}\nSIZE 4 4 4 4 4 4\nTYPE F F F F F F\n"
              f"COUNT 1 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {mode}\n")
    with open(path, "wb") as fp:
        fp.write(header.encode("ascii"))
        if mode == "ascii":
            np.savetxt(fp, points.T, fmt="%.6f")
        elif mode == "binary":
            fp.write(points.T.astype(np.float32).tobytes())
        else:   # column-major payload, LZF with back references
            payload = b"".join(points[i].astype(np.float32).tobytes() for i in range(points.shape[0]))
            comp = lzf_compress_greedy(payload)
            fp.write(struct.pack("<II", len(comp), len(payload)) + comp)


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_load_pcd_matches_jax_bit_for_bit(mode, tmp_path):
    rng = np.random.default_rng(1)
    points = np.round(rng.normal(0, 10, (6, 700)), 2).astype(np.float32)
    points[4:] = rng.integers(0, 4, (2, 700))   # ring, lidar id: repeated values LZF can reference
    path = tmp_path / f"pc_{mode}.pcd"
    _write_pcd(path, points, mode)
    got, want = pdc.load_pcd(path), jdc.load_pcd(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (6, 700)
    np.testing.assert_array_equal(got, want)
    if mode != "ascii":
        np.testing.assert_array_equal(got, points)


def _loaders(synthetic_log, sensors, frame_interval=1):
    logs_dir, blobs_dir = synthetic_log
    loader = SceneLoader(logs_dir, blobs_dir, pdc.SceneFilter(frame_interval=frame_interval),
                         sensors(pdc.SensorConfig), build_map_api=False)
    jloader = JSceneLoader(logs_dir, blobs_dir, jdc.SceneFilter(frame_interval=frame_interval),
                           sensors(jdc.SensorConfig), build_map_api=False)
    return loader, jloader


def test_agent_input_sensors_from_disk_match_jax(synthetic_log):
    """Every camera of every history frame and every cloud, read from the
    JPEG and PCD blobs, equal to JAX's."""
    loader, jloader = _loaders(synthetic_log, lambda cls: cls.build_all_sensors(), frame_interval=14)
    token = loader.tokens[0]
    got, want = loader.get_agent_input_from_token(token), jloader.get_agent_input_from_token(token)
    assert len(got.cameras) == len(want.cameras) == 4
    for cams, jcams in zip(got.cameras, want.cameras):
        for name in pdc.CAMERA_NAMES:
            cam, jcam = getattr(cams, name), getattr(jcams, name)
            assert cam.image.shape == (1080, 1920, 3) and cam.image.dtype == np.uint8
            for field in ("image", "sensor2lidar_rotation", "sensor2lidar_translation", "intrinsics", "distortion"):
                np.testing.assert_array_equal(getattr(cam, field), getattr(jcam, field), err_msg=f"{name}.{field}")
    for lidar, jlidar in zip(got.lidars, want.lidars):
        assert lidar.lidar_pc.shape == (6, 500)
        np.testing.assert_array_equal(lidar.lidar_pc, jlidar.lidar_pc)
    only_current = SceneLoader(*synthetic_log, pdc.SceneFilter(frame_interval=14),
                               pdc.SensorConfig.build_all_sensors([3]), build_map_api=False)
    agent_input = only_current.get_agent_input_from_token(token)
    assert agent_input.cameras[0].cam_f0.image is None and agent_input.lidars[0].lidar_pc is None
    assert agent_input.cameras[3].cam_b0.image is not None


def _builders(kind):
    """(port builders, JAX builders) of one kind at tiny_config."""
    from diffusiondrive_tpu.agents.diffusiondrive import features as jf

    from diffusiondrive_torch.agents.diffusiondrive import features as pf

    jcfg = tiny_config()
    cfg = _port_config(jcfg)
    if kind == "host":
        return [pf.TransfuserFeatureBuilder(cfg)], [jf.TransfuserFeatureBuilder(jcfg)]
    if kind == "raw":
        return [pf.RawSensorFeatureBuilder(cfg, max_points=1024)], [jf.RawSensorFeatureBuilder(jcfg, max_points=1024)]
    return [pf.TransfuserTargetBuilder(cfg)], [jf.TransfuserTargetBuilder(jcfg)]


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["host", "raw", "target"])
def test_dataset_cache_matches_jax_and_resumes(kind, synthetic_log, tmp_path, monkeypatch):
    loader, jloader = _loaders(synthetic_log, lambda cls: cls(cam_f0=[3], cam_l0=[3], cam_l1=False, cam_l2=False,
                                                             cam_r0=[3], cam_r1=False, cam_r2=False,
                                                             cam_b0=False, lidar_pc=[3]))
    builders, jbuilders = _builders(kind)
    split = lambda b: (b, []) if kind != "target" else ([], b)  # noqa: E731  (features, targets)
    written = []
    dump = pds.dump_feature_target
    monkeypatch.setattr(pds, "dump_feature_target", lambda data, path: (written.append(path), dump(data, path)))
    dataset = pds.Dataset(loader, *split(builders), cache_path=str(tmp_path / "port"), num_workers=2)
    jds.Dataset(jloader, *split(jbuilders), cache_path=str(tmp_path / "jax"))
    name = builders[0].get_unique_name()
    files = sorted((tmp_path / "port").glob(f"*/*/{name}.gz"))
    assert len(files) == len(loader) == 2 and sorted(written) == files
    for f in files:
        _assert_same(pds.load_feature_target(f), jds.load_feature_target(tmp_path / "jax" / f.relative_to(tmp_path / "port")))

    written.clear()
    again = pds.Dataset(loader, *split(builders), cache_path=str(tmp_path / "port"))
    assert written == []   # resumable: every file is there
    pds.Dataset(loader, *split(builders), cache_path=str(tmp_path / "port"), force_cache_computation=True)
    assert sorted(written) == files
    uncached = pds.Dataset(loader, *split(builders))
    for i in range(len(loader)):
        for got, want in zip(uncached[i], again[i]):
            _assert_same(got, want)
