"""Port parity of the raw-sensor agent path: lidar splat, camera stitch,
feature builders, the agent, `.pth` weights and the bf16 forward.

The same numpy inputs go through the JAX package and the port, the port on
the CPU. `histogram2d_pallas` has no interpret switch, so the JAX side runs
its own reference, `histogram2d_jax` / `splat_points(use_pallas=False)`
(what the JAX package takes off the TPU), as `tests/test_preprocessing.py`
does. Tolerances: histogram, bins and BEV exact (integer counts, the same
float32 bin arithmetic); camera 1e-6 absolute (values in [0, 1], float32
sums that XLA may order or fuse differently); model outputs as in
`tests/test_torch_port_model.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.agents.diffusiondrive.agent import DiffusionDriveAgent as JAgent
from diffusiondrive_tpu.agents.diffusiondrive import features as jfeatures
from diffusiondrive_tpu.common import dataclasses as jdc
from diffusiondrive_tpu.models.config import TransfuserConfig as JConfig
from diffusiondrive_tpu.models.transfuser_model import DiffusionDriveModel as JModel
from diffusiondrive_tpu.ops import lidar_splat as jsplat
from diffusiondrive_tpu.ops import preprocessing as jpre
from diffusiondrive_tpu.ops.sampling import resize_bilinear_no_aa as j_resize_no_aa
from diffusiondrive_tpu.utils.port_transfuser import load_transfuser_checkpoint as j_load_checkpoint

from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
from diffusiondrive_torch.agents.diffusiondrive.features import (
    RawSensorFeatureBuilder,
    TransfuserFeatureBuilder,
)
from diffusiondrive_torch.common.dataclasses import Trajectory
from diffusiondrive_torch.entry import example_agent_input, example_point_cloud
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
from diffusiondrive_torch.ops import lidar_splat
from diffusiondrive_torch.ops.lidar_splat import _bin_indices, histogram2d, histogram2d_plain, splat_plan
from diffusiondrive_torch.ops.preprocessing import lidar_bev, pad_point_cloud, stitch_cameras
from diffusiondrive_torch.ops.sampling import resize_bilinear_no_aa
from diffusiondrive_torch.utils.port_jax import jax_to_state_dict, load_jax_variables
from diffusiondrive_torch.utils.port_transfuser import load_transfuser_state_dict

from test_port_transfuser import build_torch_skeleton
from test_torch_port_model import _port_config
from test_train import tiny_config

# Raw cameras: the side crop keeps columns 416:-416, so widths must exceed 832.
CAM_RAW = (88, 900)
NUM_POINTS = 3000
MAX_POINTS = 4096
# noise-free outputs and the noise-fixed trajectory outputs, as in test_torch_port_model.py
FREE_TOL = {"bev_semantic_map": 2e-4, "agent_states": 2e-4, "agent_labels": 2e-4}
NOISE_TOL = {"poses_cls": 5e-4, "poses_reg": 1e-3, "trajectory": 1e-3}


def _edge_cloud():
    """Points on the bin edges, just inside and outside the grid, padded
    (valid False) points and points outside the height limits."""
    f32 = np.float32
    xs = np.array([-32.0, 32.0, 0.0, 0.25, -0.25, 31.999998, -31.999998, np.nextafter(f32(32), f32(33)),
                   np.nextafter(f32(-32), f32(-33)), 12.5, 1.0, -1.0], f32)
    x, y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([x.ravel(), y.ravel(), np.full(x.size, 1.0, f32)], 1)
    heights = np.array([[5.0, 5.0, 0.2], [5.0, 5.0, 0.2000001], [5.0, 5.0, 100.0],
                        [5.0, 5.0, 99.99999], [5.0, 5.0, -3.0], [5.0, 5.0, 250.0]], f32)
    pts = np.concatenate([pts, heights])
    valid = np.ones(len(pts), bool)
    valid[::7] = False  # padded points never count, wherever they lie
    return pts, valid


def _clouds(batch, seed, num_points=NUM_POINTS, max_points=MAX_POINTS):
    rng = np.random.default_rng(seed)
    padded = [pad_point_cloud(example_point_cloud(rng, num_points), max_points) for _ in range(batch)]
    return np.stack([p for p, _ in padded]), np.stack([v for _, v in padded])


def test_histogram2d_plain_matches_jax_exactly():
    rng = np.random.default_rng(0)
    bins = 16
    ix = rng.integers(-1, bins, size=(3, 5000)).astype(np.int32)
    iy = rng.integers(0, bins, size=(3, 5000)).astype(np.int32)
    iy[ix < 0] = -1
    ix[0, :2000] = 3  # a hot bin
    iy[0, :2000] = 5
    got = histogram2d_plain(torch.from_numpy(ix), torch.from_numpy(iy), bins).numpy()
    for b in range(3):
        want = np.asarray(jsplat.histogram2d_jax(jnp.asarray(ix[b]), jnp.asarray(iy[b]), bins))
        np.testing.assert_array_equal(got[b], want)
    assert got[0, 3, 5] >= 2000 and got.dtype == np.float32


@pytest.mark.parametrize("bins", [256, 64])
def test_bins_splat_and_lidar_bev_match_jax_exactly(bins):
    """Bin indices bit for bit, then the per-cloud splat and the batched BEV."""
    pts, valid = _clouds(2, seed=1)
    edge_pts, edge_valid = _edge_cloud()
    pts[1, :len(edge_pts)], valid[1, :len(edge_pts)] = edge_pts, edge_valid
    jcfg = tiny_config() if bins == 64 else JConfig()
    cfg = _port_config(jcfg) if bins == 64 else TransfuserConfig()
    assert cfg.lidar_resolution_width == bins

    keep = valid & (pts[..., 2] < 100.0) & (pts[..., 2] > 0.2)
    got_ix, got_iy = _bin_indices(torch.from_numpy(pts[..., :2]), torch.from_numpy(keep),
                                  -32.0, 32.0, -32.0, 32.0, bins)
    want_ix, want_iy = jsplat._bin_indices(jnp.asarray(pts[..., :2]), jnp.asarray(keep),
                                           -32.0, 32.0, -32.0, 32.0, bins)
    np.testing.assert_array_equal(got_ix.numpy(), np.asarray(want_ix))
    np.testing.assert_array_equal(got_iy.numpy(), np.asarray(want_iy))
    assert (got_ix.numpy() == bins - 1).any() and (got_ix.numpy() == -1).any()

    got = lidar_bev(torch.from_numpy(pts), torch.from_numpy(valid), cfg).numpy()
    want = np.asarray(jpre.lidar_bev(jnp.asarray(pts), jnp.asarray(valid), jcfg))
    assert got.shape == (2, bins, bins, 1) and got.max() == 1.0
    np.testing.assert_array_equal(got, want)
    for b in range(2):
        one = np.asarray(jsplat.splat_points(jnp.asarray(pts[b]), jnp.asarray(valid[b]), bins=bins,
                                             use_pallas=False))
        np.testing.assert_array_equal(lidar_splat.splat_points(
            torch.from_numpy(pts[b]), torch.from_numpy(valid[b]), bins=bins).numpy(), one)


@pytest.mark.parametrize("size", [(64, 256), (16, 512), (40, 1100)])
def test_resize_bilinear_no_aa_matches_jax(size):
    """Down- and upsampling, float and uint8 input (gathered before the cast)."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, size=(2, 32, 1036, 3)).astype(np.uint8)
    want = np.asarray(j_resize_no_aa(jnp.asarray(x, jnp.float32), size))
    for inp in (torch.from_numpy(x), torch.from_numpy(x.astype(np.float32))):
        got = resize_bilinear_no_aa(inp, size)
        assert got.dtype == torch.float32 and got.shape == (2, *size, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)  # values up to 255


@pytest.mark.parametrize("out_size", [(64, 256), (256, 1024)])
def test_stitch_cameras_matches_jax(out_size):
    rng = np.random.default_rng(3)
    cams = [rng.integers(0, 256, size=(2, *CAM_RAW, 3), dtype=np.uint8) for _ in range(3)]
    got = stitch_cameras(*[torch.from_numpy(c) for c in cams], *out_size).numpy()
    want = np.asarray(jpre.stitch_cameras(*[jnp.asarray(c) for c in cams], *out_size))
    assert got.shape == (2, *out_size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _jax_agent_input(agent_input):
    """The same arrays in the JAX package's dataclasses."""
    cams = agent_input.cameras[-1]
    status = agent_input.ego_statuses[-1]
    return jdc.AgentInput(
        ego_statuses=[jdc.EgoStatus(status.ego_pose, status.ego_velocity, status.ego_acceleration,
                                    status.driving_command)],
        cameras=[jdc.Cameras(**{k: jdc.Camera(image=getattr(cams, k).image)
                                for k in jdc.CAMERA_NAMES})],
        lidars=[jdc.Lidar(agent_input.lidars[-1].lidar_pc)])


def test_pad_point_cloud_and_feature_builders_match_jax():
    for n, max_points in ((10, 64), (100, 64)):
        pc = np.random.default_rng(n).normal(size=(6, n)).astype(np.float32)
        for got, want in zip(pad_point_cloud(pc, max_points), jpre.pad_point_cloud(pc, max_points)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype

    jcfg = tiny_config()
    cfg = _port_config(jcfg)
    agent_input = example_agent_input(cfg, seed=4, num_points=NUM_POINTS, camera_shape=CAM_RAW)
    j_input = _jax_agent_input(agent_input)
    for port_builder, jax_builder in ((RawSensorFeatureBuilder(cfg, MAX_POINTS),
                                       jfeatures.RawSensorFeatureBuilder(jcfg, MAX_POINTS)),
                                      (TransfuserFeatureBuilder(cfg),
                                       jfeatures.TransfuserFeatureBuilder(jcfg))):
        assert port_builder.get_unique_name() == jax_builder.get_unique_name()
        got = port_builder.compute_features(agent_input)
        want = jax_builder.compute_features(j_input)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _random_bn(variables, rng):
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.3, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.7, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def agents():
    """The JAX agent and the port's agent (CPU, float32, raw path) with the
    same weights (random BN statistics), and a batch of raw features."""
    jcfg = tiny_config()
    cfg = _port_config(jcfg)
    jagent = JAgent(jcfg, dtype=jnp.float32, preprocess_on_device=True)
    jagent.initialize()
    jagent.variables = _random_bn(jagent.variables, np.random.default_rng(5))
    agent = DiffusionDriveAgent(cfg, dtype=torch.float32, preprocess_on_device=True, device="cpu")
    agent.model = load_jax_variables(DiffusionDriveModel(cfg), jagent.variables).eval()

    builder = RawSensorFeatureBuilder(cfg, MAX_POINTS)
    inputs = [example_agent_input(cfg, seed=10 + b, num_points=NUM_POINTS, camera_shape=CAM_RAW)
              for b in range(2)]
    feats = [builder.compute_features(a) for a in inputs]
    features = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    noise = np.random.default_rng(6).normal(
        size=(2, jcfg.ego_fut_mode, jcfg.num_poses, 2)).astype(np.float32)
    j_apply = jax.jit(lambda v, c, l, s, n: JModel(jcfg).apply(v, c, l, s, diffusion_noise=n))
    return jagent, agent, features, inputs, noise, j_apply


def _jax_raw_forward(jagent, variables, features):
    keys = ("camera_l0", "camera_f0", "camera_r0", "lidar_points", "lidar_valid", "status_feature")
    out = jagent._jit_forward_raw(variables, *[jnp.asarray(features[k]) for k in keys])
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _check_noise_fixed(agent, jagent, variables, features, noise, j_apply):
    """Each side preprocesses its own features; the models then run with
    the same diffusion noise."""
    tensors = agent.features_to_device(features)
    camera, lidar = agent.preprocess(tensors)
    j_cam = jpre.stitch_cameras(*[jnp.asarray(features[k]) for k in ("camera_l0", "camera_f0",
                                                                      "camera_r0")],
                                agent.config.camera_height, agent.config.camera_width)
    j_lidar = jpre.lidar_bev(jnp.asarray(features["lidar_points"]),
                             jnp.asarray(features["lidar_valid"]), jagent.config)
    np.testing.assert_allclose(camera.numpy(), np.asarray(j_cam), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(lidar.numpy(), np.asarray(j_lidar))
    got = agent.predict(tensors, diffusion_noise=torch.from_numpy(noise))
    want = j_apply(variables, j_cam, j_lidar, jnp.asarray(features["status_feature"]),
                   jnp.asarray(noise))
    for name, atol in {**FREE_TOL, **NOISE_TOL}.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=atol, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(got["poses_cls"].argmax(-1).numpy(),
                                  np.asarray(want["poses_cls"]).argmax(-1))


def test_agent_raw_forward_matches_jax_agent(agents):
    jagent, agent, features, inputs, _, _ = agents
    got = agent.forward(features)
    want = _jax_raw_forward(jagent, jagent.variables, features)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
    for name, atol in FREE_TOL.items():
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=1e-4, err_msg=name)
    # the noise comes from a generator re-seeded on every call: repeatable
    again = agent.forward(features)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])
    # compute_trajectory = raw builder -> batch of one -> forward -> Trajectory
    traj = agent.compute_trajectory(inputs[1])
    assert isinstance(traj, Trajectory) and traj.poses.shape == (8, 3)
    one = agent.forward({k: v[1:] for k, v in features.items()})
    np.testing.assert_array_equal(traj.poses, one["trajectory"][0])
    j_traj = jagent.compute_trajectory(_jax_agent_input(inputs[1]))
    assert j_traj.poses.shape == traj.poses.shape


def test_agent_models_match_on_preprocessed_features_with_fixed_noise(agents):
    jagent, agent, features, _, noise, j_apply = agents
    _check_noise_fixed(agent, jagent, jagent.variables, features, noise, j_apply)


def test_agent_with_cached_features_matches_raw(agents):
    """`forward` also takes the host builder's dict: fed the device's own
    stitched camera and BEV it gives the raw path's outputs."""
    _, agent, features, _, _, _ = agents
    camera, lidar = agent.preprocess(agent.features_to_device(features))
    cached = {"camera_feature": camera.numpy(), "lidar_feature": lidar.numpy(),
              "status_feature": features["status_feature"]}
    raw, via_cache = agent.forward(features), agent.forward(cached)
    for k in raw:
        np.testing.assert_array_equal(via_cache[k], raw[k])


def test_pth_checkpoint_loads_exactly_and_drives_the_agent(agents, tmp_path):
    jagent, _, features, _, noise, j_apply = agents
    jcfg = tiny_config()
    cfg = _port_config(jcfg)
    torch.manual_seed(0)
    skeleton = build_torch_skeleton(jcfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in skeleton.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.7, 1.5, generator=gen)
    path = tmp_path / "diffusiondrive.ckpt"  # lightning layout: 'agent.'-prefixed state_dict
    torch.save({"state_dict": {f"agent.{k}": v for k, v in skeleton.state_dict().items()}}, path)

    j_vars = j_load_checkpoint(str(path), jcfg)
    got = load_transfuser_state_dict(str(path), DiffusionDriveModel(cfg))
    want = jax_to_state_dict(j_vars, DiffusionDriveModel(cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    agent = DiffusionDriveAgent(cfg, checkpoint_path=str(path), dtype=torch.float32,
                                preprocess_on_device=True, device="cpu")
    agent.initialize()
    out = agent.forward(features)
    j_out = _jax_raw_forward(jagent, j_vars, features)
    for name, atol in FREE_TOL.items():
        np.testing.assert_allclose(out[name], j_out[name], atol=atol, rtol=1e-4, err_msg=name)
    _check_noise_fixed(agent, jagent, j_vars, features, noise, j_apply)


def test_bf16_planner_forward_matches_jax_bf16(agents):
    """The agent serves in bf16. Port bf16 (CPU) against JAX bf16 (CPU), same
    weights, inputs and noise. Tolerance: bf16 keeps 8 mantissa bits and the
    two frameworks round at different places (a conv's output before or
    after the folded BN, a matmul's accumulator), so each bf16 forward
    lies some way off the float32 one. The port's bf16 gap to JAX bf16 must
    stay within 3x JAX bf16's own gap to JAX float32 (plus 1e-2 for outputs
    that barely move), per output, with equal argmax modes; a larger gap is
    the port's fault. Measured here: at most 1.6x (`agent_states`)."""
    jagent, _, features, _, noise, _ = agents
    jcfg = tiny_config()
    cfg = _port_config(jcfg)
    variables = jagent.variables
    cam = jpre.stitch_cameras(*[jnp.asarray(features[k]) for k in ("camera_l0", "camera_f0",
                                                                    "camera_r0")],
                              jcfg.camera_height, jcfg.camera_width)
    lidar = jpre.lidar_bev(jnp.asarray(features["lidar_points"]),
                           jnp.asarray(features["lidar_valid"]), jcfg)
    status = jnp.asarray(features["status_feature"])
    args = (variables, cam, lidar, status, jnp.asarray(noise))
    apply = lambda dtype: jax.jit(  # noqa: E731
        lambda v, c, l, s, n: JModel(jcfg, dtype=dtype).apply(v, c, l, s, diffusion_noise=n))
    j32 = {k: np.asarray(v, np.float32) for k, v in apply(jnp.float32)(*args).items()}
    j16 = {k: np.asarray(v, np.float32) for k, v in apply(jnp.bfloat16)(*args).items()}
    model = load_jax_variables(DiffusionDriveModel(cfg, dtype=torch.bfloat16), variables).eval()
    with torch.no_grad():
        out = model(*[torch.from_numpy(np.array(a)) for a in (cam, lidar, status)],
                    diffusion_noise=torch.from_numpy(noise))
    for k in j32:
        port_gap = np.abs(out[k].float().numpy() - j16[k]).max()
        jax_gap = np.abs(j16[k] - j32[k]).max()
        assert port_gap <= 3 * jax_gap + 1e-2, (k, port_gap, jax_gap)
    np.testing.assert_array_equal(out["poses_cls"].argmax(-1).numpy(), j16["poses_cls"].argmax(-1))


def test_cpu_histogram_takes_the_plain_version_and_counts_no_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(lidar_splat, "histogram2d_plain",
                        lambda *a: calls.append(1) or histogram2d_plain(*a))
    launches = histogram2d.launches
    pts, valid = _clouds(2, seed=7)
    lidar_bev(torch.from_numpy(pts), torch.from_numpy(valid))
    assert calls == [1] and histogram2d.launches == launches


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("bins", [16, 64, 256, 300, 512])
def test_splat_plan_covers_every_row_and_point_within_the_card(bins, B):
    """The splat kernel's launch plan at the agent path's N: its bands cover
    every histogram row once, a block's band fits the H100's 227 KB of
    shared memory as 16-bit counts, no segment can carry a 16-bit count
    over (<= 65535 points), the segments cover all B*N points, and the grid
    gives every one of the 132 SMs a block."""
    N = 131072
    plan = splat_plan(B, N, bins, sms=132)  # an H100 SXM
    rows = [r for band in range(plan.bands) for r in range(band * plan.band_rows,
                                                           min(bins, (band + 1) * plan.band_rows))]
    assert rows == list(range(bins))
    assert 2 * plan.band_rows * bins <= plan.smem <= 232448 and plan.smem % 16 == 0
    assert 0 < plan.segment <= 65535
    assert (plan.segments - 1) * plan.segment < B * N <= plan.segments * plan.segment
    assert plan.bands * plan.segments >= 132


def test_histogram_off_the_cpu_reaches_the_kernel_or_raises():
    """A non-CPU tensor never takes the plain version: the wrapper checks the
    kernel's contract, then raises for a device without a kernel."""
    ix = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="int32"):
        histogram2d(ix.long(), ix.long(), 16)
    with pytest.raises(RuntimeError, match="no kernel"):
        histogram2d(ix, ix, 16)


def test_agent_raises_without_gpu_unless_cpu_is_asked():
    from diffusiondrive_torch.entry import agent_entry

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionDriveAgent()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        agent_entry()
    agent = DiffusionDriveAgent(device="cpu")
    assert agent.device == torch.device("cpu") and agent.model is None


def test_agent_contract_pieces(tmp_path):
    cfg = _port_config(tiny_config())
    agent = DiffusionDriveAgent(cfg, device="cpu", preprocess_on_device=True)
    assert agent.get_sensor_config().get_sensors_at_iteration(3) == ["cam_f0", "cam_l0", "cam_r0",
                                                                     "lidar_pc"]
    assert isinstance(agent.get_feature_builders()[0], RawSensorFeatureBuilder)
    assert isinstance(DiffusionDriveAgent(cfg, device="cpu").get_feature_builders()[0],
                      TransfuserFeatureBuilder)
    # the training interface (held against JAX in test_torch_port_train.py)
    assert type(agent.get_target_builders()[0]).__name__ == "TransfuserTargetBuilder"
    assert [type(c).__name__ for c in agent.get_training_callbacks()] == ["TimeLoggingCallback"]
    optimizer, _ = agent.get_optimizers()
    assert {g["label"] for g in optimizer.param_groups} == {"default", "image_encoder"}
    # a checkpoint path that is neither a reference .pth nor a trainer checkpoint directory
    with pytest.raises(FileNotFoundError):
        DiffusionDriveAgent(cfg, checkpoint_path=str(tmp_path / "ckpt"), device="cpu").initialize()
    # seeded weights, idempotent initialize, and the plan-anchor override
    anchors = np.random.default_rng(8).normal(size=(cfg.ego_fut_mode, cfg.num_poses, 2))
    np.save(tmp_path / "anchors.npy", anchors)
    seeded = DiffusionDriveAgent(
        dataclasses.replace(cfg, plan_anchor_path=str(tmp_path / "anchors.npy")),
        dtype=torch.float32, seed=3, device="cpu")
    seeded.initialize()
    model = seeded.model
    seeded.initialize()
    assert seeded.model is model
    np.testing.assert_array_equal(model.trajectory_head.plan_anchor.numpy(), anchors.astype(np.float32))
    other = DiffusionDriveAgent(cfg, dtype=torch.float32, seed=3, device="cpu")
    other.initialize()
    w = "backbone.image_encoder_stem.conv1.weight"
    assert torch.equal(other.model.state_dict()[w], model.state_dict()[w])
