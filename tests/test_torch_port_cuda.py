"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: skips without a GPU. The file imports torch only (no JAX), so
it runs on a machine without JAX; run it there with
``python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest -o addopts=""``.
"""

import numpy as np
import pytest
import torch

from diffusiondrive_torch.models.resnet import ResNetStem, _kernel_operands
from diffusiondrive_torch.ops.attention_fused import (
    attention_bwd_plain, attention_fwd_plain, backward_kernel, dropout_keep_mask, forward_kernel, fused_attention,
    fused_attention_bwd)
from diffusiondrive_torch.ops.conv_fused import (
    conv3x3_kernel, conv3x3_plain, conv3x3_train, conv3x3_train_plain, fused_conv3x3, to_hwio)
from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment, linear_sum_assignment_plain
from diffusiondrive_torch.ops.lidar_splat import histogram2d, histogram2d_plain, splat_plan
from diffusiondrive_torch.ops.stem_fused import fused_stem, stem_kernel, stem_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: python -m pytest -m cuda)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol, name):
    err = (got.float() - want.float()).abs().max().item()
    limit = tol * max(1.0, want.float().abs().max().item())
    assert err <= limit, (name, err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, tol):
    """On the card: each kernel against its plain version at odd edges
    (H, W not multiples of the tiles). bf16: the conv's plain version rounds
    once, at the end, as its kernel does, so a bf16 conv also holds 2 bf16
    ulps of max |plain|."""
    g = torch.Generator().manual_seed(0)
    s, b = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g) * 0.1
    for C in (1, 3):
        x = torch.randn(2, 36, 100, C, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
        w = torch.randn(64, C, 7, 7, generator=g) * 0.1
        args = (to_hwio(w.to(cuda_device), dtype), s.to(cuda_device), b.to(cuda_device))
        got, want = fused_stem(x, *args).float(), stem_plain(x, *args).float()
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    x = torch.randn(2, 20, 36, 64, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
    r = torch.randn(2, 20, 36, 64, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
    w = to_hwio((torch.randn(64, 64, 3, 3, generator=g) * 0.05).to(cuda_device), dtype)
    for res, relu in ((None, False), (r, True)):
        got = fused_conv3x3(x, w, s.to(cuda_device), b.to(cuda_device), res, relu).float()
        want = conv3x3_plain(x, w, s.to(cuda_device), b.to(cuda_device), res, relu).float()
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
        if dtype == torch.bfloat16:
            _within_2_bf16_ulps(got, want, "conv3x3")
    torch.cuda.synchronize()


def _kernel_names(fn) -> set:
    """Names of the CUDA kernels `fn` launches, from the profiler's device
    events. A trace that holds no device event (the profiler may lose the
    kernel records of a short window and keep only the runtime calls) is
    taken again, at most three times."""
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            return names
    return set()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,W", [(2, 20, 36), (1, 33, 70), (8, 64, 256)])
def test_cuda_conv3x3_kernel_matches_plain_version(cuda_device, dtype, tol, B, H, W):
    """The conv3x3 kernel the dtype picks (bf16: bf16 products on the tensor
    cores, "mma"; float32: three TF32 products a product on the tensor
    cores, "mma_tf32x3"; the profiler names the kernel that ran) against its
    plain version: ragged tiles (20x36, 33x70: H and W not multiples of the
    16x16 tile) and B=8 at 64x256 (512 tiles, more than the card's blocks,
    so the persistent loop turns, and float32's two channel-half stages a
    tile alternate their buffers over it), without and with the residual
    and the ReLU; bf16 also within 2 bf16 ulps; the same bits in two calls;
    one launch each."""
    g = torch.Generator().manual_seed(B * H * W)
    x, r = (torch.randn(B, H, W, 64, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2) for _ in range(2))
    w = to_hwio((torch.randn(64, 64, 3, 3, generator=g) / 24.0).to(cuda_device), dtype)
    s = (torch.rand(64, generator=g) + 0.5).to(cuda_device)
    b = (torch.randn(64, generator=g) * 0.1).to(cuda_device)
    for res, relu in ((None, False), (None, True), (r, False), (r, True)):
        before = fused_conv3x3.launches
        got, again = fused_conv3x3(x, w, s, b, res, relu), fused_conv3x3(x, w, s, b, res, relu)
        want = conv3x3_plain(x, w, s, b, res, relu)
        torch.cuda.synchronize()
        assert fused_conv3x3.launches == before + 2
        assert got.dtype == dtype and got.shape == x.shape
        assert got.is_contiguous(memory_format=torch.channels_last)
        _close(got, want, tol, (res is not None, relu))
        if dtype == torch.bfloat16:
            _within_2_bf16_ulps(got, want, (res is not None, relu))
        assert torch.equal(got, again)
    path = conv3x3_kernel(dtype)
    assert path == ("mma" if dtype == torch.bfloat16 else "mma_tf32x3")
    names = _kernel_names(lambda: fused_conv3x3(x, w, s, b, r, True))
    assert any("conv3x3_mma_kernel" in n for n in names) == (path == "mma"), names
    assert any("conv3x3_tf32x3_kernel" in n for n in names) == (path == "mma_tf32x3"), names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,W,Cs,bias", [(2, 36, 100, (1, 2, 3, 4), None), (1, 68, 132, (1, 2, 3, 4), None),
                                           (2, 36, 100, (1, 2, 3, 4), -2.0), (1, 256, 1024, (3,), None)])
def test_cuda_stem_kernel_matches_plain_version(cuda_device, dtype, tol, B, H, W, Cs, bias):
    """The stem kernel the dtype picks, for every C = 1..4 (bf16: bf16
    products on the tensor cores, "mma"; float32: three TF32 products a
    product on the tensor cores, "mma_tf32x3"; the profiler names the kernel
    that ran) against its plain version: odd edges (36x100 gives 9x25
    pooled outputs, 68x132 17x33: neither a multiple of bf16's 8x16 tile nor
    of float32's 8x7), a bias of -2 that drives whole regions to ReLU's zero
    (the pool's zero padding must still equal -inf padding), and the camera
    at B=1 (NAVSIM's per-scene call: 128 bf16 tiles, about one a block; 296
    float32 tiles, so the persistent loop turns); bf16 also within 2 bf16
    ulps (kernel and plain version round once, at the same place); the same
    bits in two calls; one launch each."""
    g = torch.Generator().manual_seed(H * W)
    s = (torch.rand(64, generator=g) + 0.5).to(cuda_device)
    b = (torch.randn(64, generator=g) * 0.1 if bias is None else torch.full((64,), bias)).to(cuda_device)
    for C in Cs:
        x = torch.randn(B, H, W, C, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
        w = to_hwio((torch.randn(64, C, 7, 7, generator=g) * 0.1).to(cuda_device), dtype)
        before = fused_stem.launches
        got, again = fused_stem(x, w, s, b), fused_stem(x, w, s, b)
        want = stem_plain(x, w, s, b)
        torch.cuda.synchronize()
        assert fused_stem.launches == before + 2
        assert got.dtype == dtype and got.shape == (B, 64, H // 4, W // 4)
        assert got.is_contiguous(memory_format=torch.channels_last)
        _close(got, want, tol, f"stem C={C}")
        if dtype == torch.bfloat16:
            _within_2_bf16_ulps(got, want, f"stem C={C}")
        assert torch.equal(got, again), f"stem C={C}"
    path = stem_kernel(dtype)
    assert path == ("mma" if dtype == torch.bfloat16 else "mma_tf32x3")
    names = _kernel_names(lambda: fused_stem(x, w, s, b))
    assert any("stem_mma_kernel" in n for n in names) == (path == "mma"), names
    assert any("stem_tf32x3_kernel" in n for n in names) == (path == "mma_tf32x3"), names


@pytest.mark.cuda
def test_cuda_stem_with_unsupported_shape_raises(cuda_device):
    """On the card the stem's wrapper launches the kernel or raises: no plain path."""
    stem = ResNetStem(5).to(cuda_device).eval()
    w, s, b = _kernel_operands(stem, "conv1", "bn1", torch.float32)
    x = torch.zeros(1, 5, 64, 64, device=cuda_device).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="not supported"):
        fused_stem(x, w, s, b)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [5, 6])
def test_cuda_stem_takes_the_module_path_where_the_kernel_does_not_apply(cuda_device, C):
    """An eval stem with C > 4 (as JAX, by `supports_fused_stem`) runs conv,
    BN, ReLU and max-pool on the card, launches no stem kernel, and equals
    the same module on the CPU within 1e-4 (float32, TF32 off)."""
    torch.manual_seed(C)
    stem = ResNetStem(C).eval()
    with torch.no_grad():
        stem.bn1.running_mean.normal_(0.0, 0.3)
        stem.bn1.running_var.uniform_(0.7, 1.5)
    x = torch.randn(2, C, 36, 100, generator=torch.Generator().manual_seed(C))
    before = fused_stem.launches
    with torch.no_grad():
        want = stem(x)
        got = stem.to(cuda_device)(x.to(cuda_device))
    torch.cuda.synchronize()
    assert fused_stem.launches == before
    _close(got.cpu(), want, 1e-4, f"stem C={C}")


def _one_bin(B, N, bins, cell=(5, 7)):
    return (torch.full((B, N), cell[0], dtype=torch.int32), torch.full((B, N), cell[1], dtype=torch.int32))


def _splat_case(case, sms):
    """(ix, iy, bins) of one card case of the splat, on the CPU."""
    g = torch.Generator().manual_seed(4)
    kind, B, N, bins = case
    if kind == "random":  # a hot bin, skipped points (either index -1)
        ix = torch.randint(-1, bins, (B, N), generator=g, dtype=torch.int32)
        iy = torch.randint(-1, bins, (B, N), generator=g, dtype=torch.int32)
        ix[:, : N // 3], iy[:, : N // 3] = 5, 7
        return ix, iy, bins
    if kind == "one_bin":  # every point of the cloud in one bin
        return (*_one_bin(B, N, bins), bins)
    if kind == "one_bin_per_sm":  # N/sms points a segment: at and around 65535 a block
        return (*_one_bin(B, N * sms, bins), bins)
    if kind == "hot_across_segments":  # one hot bin across the first segments' boundaries
        ix = torch.randint(0, bins, (B, N), generator=g, dtype=torch.int32)
        iy = torch.randint(0, bins, (B, N), generator=g, dtype=torch.int32)
        seg = splat_plan(B, N, bins, sms).segment
        ix[0, seg - 300: 3 * seg + 300], iy[0, seg - 300: 3 * seg + 300] = 100, 200
        return ix, iy, bins
    if kind == "skipped":  # every point skipped
        return torch.full((B, N), -1, dtype=torch.int32), torch.randint(0, bins, (B, N), generator=g,
                                                                         dtype=torch.int32), bins
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("random", 3, 5000, 256), ("random", 2, 1000, 64), ("random", 1, 0, 16), ("random", 2, 777, 300),
    ("random", 2, 3001, 512), ("random", 16, 131072, 256), ("random", 1, 131072, 16),
    ("one_bin", 1, 65535, 256), ("one_bin", 1, 65536, 256), ("one_bin", 1, 65537, 256),
    ("one_bin_per_sm", 1, 65535, 16), ("one_bin_per_sm", 1, 65536, 16), ("one_bin_per_sm", 1, 65537, 16),
    ("hot_across_segments", 1, 131072, 256), ("skipped", 2, 4096, 256)],
    ids=lambda c: "-".join(map(str, c)))
def test_cuda_histogram_matches_plain_version_exactly(cuda_device, case):
    """Counts are integers: the kernel equals its plain version exactly, the
    same bits in two calls, one launch a call. Covers a hot bin, skipped
    points (either index -1, or all), an empty cloud, one band of 300 rows
    and three bands at 512, a bin of 65535-65537 points in one cloud and of
    65535-65537 points a block (a segment's 16-bit counts at and around their
    limit), and a hot bin across segment boundaries."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ix, iy, bins = _splat_case(case, sms)
    B, N = ix.shape
    plan = splat_plan(B, N, bins, sms)
    if case[0] == "one_bin_per_sm":
        assert plan.segment == 65535 if case[2] == 65535 else plan.segment < 65535
    ix, iy = ix.to(cuda_device), iy.to(cuda_device)
    want = histogram2d_plain(ix, iy, bins)
    torch.testing.assert_close(want.cpu(), histogram2d_plain(ix.cpu(), iy.cpu(), bins), rtol=0, atol=0)
    got = []
    for _ in range(2):
        before = histogram2d.launches
        got.append(histogram2d(ix, iy, bins))
        torch.cuda.synchronize()
        assert histogram2d.launches == before + 1
        assert got[-1].shape == (B, bins, bins) and torch.equal(got[-1], want)
    assert torch.equal(got[0].view(torch.int32), got[1].view(torch.int32))
    with pytest.raises(TypeError, match="int32"):
        histogram2d(ix.long(), iy.long(), bins)


def _lap_costs(kind, B, n, rng):
    if kind == "mixed":  # half normal, half integer costs in [0, 4): ties
        costs = rng.normal(size=(B, n, n)).astype(np.float32)
        costs[B // 2:] = rng.integers(0, 4, size=(B - B // 2, n, n))
        return costs
    if kind == "signed_zero":  # -0.0 and +0.0 tie as floats; the kernel keys them alike
        return rng.choice(np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0], np.float32), size=(B, n, n))
    if kind == "equal":
        return np.full((B, n, n), 2.5, np.float32)
    if kind == "sentinel":  # huge finite costs below the 1e18 sentinel
        return rng.uniform(1e17, 9e17, size=(B, n, n)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "signed_zero", "equal", "sentinel"])
@pytest.mark.parametrize("n,B", [(1, 3), (7, 5), (30, 64), (31, 9), (30, 1), (31, 5)])
def test_cuda_assignment_equals_plain_version_and_scipy(cuda_device, n, B, kind):
    """The LAP kernel gives the plain version's assignment exactly (ties
    included: integer costs, signed zeros, all-equal costs) and scipy's
    optimal total cost, also next to the sentinel and at batches that are
    no multiple of the kernel's problems per block."""
    from scipy.optimize import linear_sum_assignment

    costs = _lap_costs(kind, B, n, np.random.default_rng(n))
    c = torch.from_numpy(costs).to(cuda_device)
    before = batched_linear_sum_assignment.launches
    got = batched_linear_sum_assignment(c)
    torch.cuda.synchronize()
    assert batched_linear_sum_assignment.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (B, n)
    torch.testing.assert_close(got, linear_sum_assignment_plain(c), rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), linear_sum_assignment_plain(c.cpu()), rtol=0, atol=0)
    for cb, col in zip(costs, got.cpu().numpy()):
        r, cs = linear_sum_assignment(cb)
        np.testing.assert_allclose(cb[np.arange(n), col].sum(dtype=np.float64),
                                   cb[r, cs].sum(dtype=np.float64), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="outside the kernel"):
        batched_linear_sum_assignment(torch.zeros(2, 32, 32, device=cuda_device))


@pytest.mark.cuda
def test_cuda_detection_loss_above_the_kernel_size_takes_the_plain_solver(cuda_device):
    """n = 40 > 31: the loss solves on the card with the plain solver (no LAP
    launch), which gives the CPU's assignment exactly; the loss equals the
    CPU's within 1e-5. Each prediction is a ground-truth box of a
    permutation plus noise, its logit +-4 by that box's label: one optimum
    up to swaps among invalid boxes, which leave the loss as it is (with
    logits near 0 the optimum ties, and the last bit of the card's cost
    picks another)."""
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.training.losses import agent_detection_loss

    rng = np.random.default_rng(40)
    B, n = 3, 40
    costs = torch.from_numpy(rng.normal(size=(B, n, n)).astype(np.float32))
    torch.testing.assert_close(linear_sum_assignment_plain(costs.to(cuda_device)).cpu(),
                               linear_sum_assignment_plain(costs), rtol=0, atol=0)
    gt = rng.normal(0, 10, (B, n, 5)).astype(np.float32)
    labels, perm = rng.uniform(size=(B, n)) > 0.4, rng.permutation(n)
    inputs = ({"agent_states": gt, "agent_labels": labels},
              {"agent_states": (gt[:, perm] + rng.normal(0, 0.5, (B, n, 5))).astype(np.float32),
               "agent_labels": (np.where(labels[:, perm], 4.0, -4.0) + rng.normal(0, 0.5, (B, n))).astype(np.float32)})
    cfg = TransfuserConfig(num_bounding_boxes=n)
    before = batched_linear_sum_assignment.launches
    got, want = (torch.stack(agent_detection_loss(*({k: torch.from_numpy(v).to(d) for k, v in part.items()}
                                                    for part in inputs), cfg))
                 for d in (cuda_device, torch.device("cpu")))
    torch.cuda.synchronize()
    assert batched_linear_sum_assignment.launches == before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_add_noise_takes_per_sample_timesteps(cuda_device):
    from diffusiondrive_torch.ops.ddim import DDIMScheduler

    g = torch.Generator().manual_seed(0)
    x, eps = torch.randn(4, 20, 8, 2, generator=g), torch.randn(4, 20, 8, 2, generator=g)
    t = torch.tensor([0, 49, 7, 31])
    sched = DDIMScheduler()
    want = sched.add_noise(x, eps, t)
    got = sched.add_noise(x.to(cuda_device), eps.to(cuda_device), t.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One train step at a small config on the card (the LAP kernel, cuDNN
    convolutions) against the same step on the CPU, with a float64 step on
    each as the witness, held to `chip_smoke.py`'s limits on the step's own
    sides:
    loss terms within 1e-3 x max(1, |CPU|); per parameter, the card's
    float64 gradient within 1e-6 relative L2 of the CPU's, and its float32
    gradient within min(1e-2 + 2x the CPU float32 gradient's distance, 0.1)
    of the CPU's float64 one (a float32 step puts some ReLUs on the other
    side of their kink: PERF.md §6); BN statistics within 1e-4."""
    from diffusiondrive_torch.entry import build_model, comparison_batch, grad_distances, train_step_on
    from diffusiondrive_torch.models.config import TransfuserConfig

    cfg = TransfuserConfig(image_architecture="resnet18", lidar_architecture="resnet18",
                           camera_height=64, camera_width=256, lidar_resolution_height=64,
                           lidar_resolution_width=64, img_vert_anchors=2, img_horz_anchors=8,
                           lidar_vert_anchors=2, lidar_horz_anchors=2, bev_pixel_height=32,
                           bev_pixel_width=64)
    model = build_model(cfg, seed=0).train()
    batch, ts, noise = comparison_batch(model, cfg, 2, seed=0)
    runs = {(d.type, dt): train_step_on(model, cfg, batch, ts, noise, d, dt)
            for d in (torch.device("cpu"), cuda_device) for dt in (torch.float32, torch.float64)}
    f32, f64 = torch.float32, torch.float64
    assert runs[("cuda", f32)]["lap_launches"] == 1 and runs[("cuda", f64)]["lap_launches"] == 1
    for k, v in runs[("cpu", f32)]["losses"].items():
        assert abs(runs[("cuda", f32)]["losses"][k] - v) <= 1e-3 * max(1.0, abs(v)), k
    ref = runs[("cpu", f64)]["grads"]
    card64 = grad_distances(runs[("cuda", f64)]["grads"], ref)
    assert max(card64.values()) <= 1e-6, max(card64.items(), key=lambda kv: kv[1])
    cpu32 = grad_distances(runs[("cpu", f32)]["grads"], ref)
    for k, dist in grad_distances(runs[("cuda", f32)]["grads"], ref).items():
        assert dist <= min(1e-2 + 2.0 * cpu32[k], 0.1), (k, dist, cpu32[k])
    for k, b in runs[("cpu", f32)]["stats"].items():
        torch.testing.assert_close(runs[("cuda", f32)]["stats"][k], b, rtol=1e-4, atol=1e-4, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["diffusion_policy_agent", "diffusiondrive_nuscenes_agent", "transfuser_agent"])
def test_cuda_variant_forward_and_train_step(cuda_device, name):
    """Each registry variant (`entry.VARIANTS`) at a small width on the card:
    the float32 eval forward with fixed noise against the CPU's within
    1e-3 x max(1, |CPU|), launching 2 stem and, in the ResNet-18 layer 1,
    8 conv3x3 kernels (ResNet-50's Bottleneck: 0, as in JAX); the bf16
    forward finite with the same launches; one train step card vs CPU as
    `test_cuda_train_step_matches_cpu` (1 LAP launch, float64 gradients
    1e-6 relative L2), its float32 losses within 1e-3 x max(1, |CPU|) of
    the CPU's float32 ones. The box term may move further: it is the L1 of
    residuals of ~0.1 m against boxes of up to 32 m, so it carries each
    box's float32 error whole. Its gate adds twice what the CPU float32
    step's boxes allow it to move from float64
    (`entry.box_loss_move_bound`), a card step held to the CPU's float32
    accuracy. ResNet-50 at this width needs that: cuDNN's float32
    convolutions leave the card's boxes 1.8x as far from float64 as the
    CPU's, or the card's with cuDNN off (`script/run_kinks.py --variant
    diffusiondrive_nuscenes_agent --small`, PERF.md §6)."""
    from diffusiondrive_torch.entry import (
        box_loss_move_bound, build_model, comparison_batch, grad_distances, train_step_on, variant_config)

    small = dict(camera_height=64, camera_width=256, lidar_resolution_height=64, lidar_resolution_width=64,
                 img_vert_anchors=2, img_horz_anchors=8, lidar_vert_anchors=2, lidar_horz_anchors=2,
                 bev_pixel_height=32, bev_pixel_width=64, unet_down_dims=(32, 64))
    r50 = name == "diffusiondrive_nuscenes_agent"
    head, cfg = variant_config(name, **small, **({} if r50 else {"image_architecture": "resnet18",
                                                                 "lidar_architecture": "resnet18"}))
    model = build_model(cfg, seed=0, trajectory_head_type=head)
    g = torch.Generator().manual_seed(1)
    inputs = {"camera_feature": torch.randint(0, 256, (2, 64, 256, 3), generator=g, dtype=torch.uint8),
              "lidar_feature": torch.rand(2, 64, 64, 1, generator=g), "status_feature": torch.randn(2, 8, generator=g)}
    noise = model.trajectory_head.draw_noise(2, torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(**inputs, diffusion_noise=noise)
        for dtype in (torch.float32, torch.bfloat16):
            card = build_model(cfg, dtype, seed=0, trajectory_head_type=head).to(cuda_device)
            stem0, conv0 = fused_stem.launches, fused_conv3x3.launches
            got = card(**{k: v.to(cuda_device) for k, v in inputs.items()},
                       diffusion_noise=None if noise is None else noise.to(cuda_device))
            torch.cuda.synchronize()
            assert (fused_stem.launches - stem0, fused_conv3x3.launches - conv0) == (2, 0 if r50 else 8)
            assert set(got) == set(want) and got["trajectory"].shape == (2, cfg.num_poses, 3)
            for k, w in want.items():
                assert torch.isfinite(got[k].float()).all(), k
                if dtype == torch.float32:
                    _close(got[k].cpu(), w, 1e-3, k)
    model.train()
    batch, ts, tnoise = comparison_batch(model, cfg, 2, seed=0)
    runs = {(d.type, dt): train_step_on(model, cfg, batch, ts, tnoise, d, dt, record=True)
            for d in (torch.device("cpu"), cuda_device) for dt in (torch.float32, torch.float64)}
    assert runs[("cuda", torch.float32)]["lap_launches"] == 1
    card64 = grad_distances(runs[("cuda", torch.float64)]["grads"], runs[("cpu", torch.float64)]["grads"])
    assert max(card64.values()) <= 1e-6, max(card64.items(), key=lambda kv: kv[1])
    cpu_move = box_loss_move_bound(runs[("cpu", torch.float32)], runs[("cpu", torch.float64)],
                                   torch.from_numpy(batch["agent_labels"]).bool(), cfg)
    for k, v in runs[("cpu", torch.float32)]["losses"].items():
        limit = 1e-3 * max(1.0, abs(v)) + (2.0 * cpu_move if k == "agent_box_loss" else 0.0)
        assert abs(runs[("cuda", torch.float32)]["losses"][k] - v) <= limit, (k, cpu_move)


def _within_2_bf16_ulps(got, want, name):
    """`chip_smoke.py:check_bf16_ulps`: 2 bf16 ulps (2 * 2^-8) of max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    limit = 2.0 * 2.0 ** -8 * want.float().abs().max().item()
    assert err <= limit, (name, err, limit)


def _attention_inputs(B, H, T, D, dtype, masked, device, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(device, dtype).transpose(1, 2)
                   for _ in range(4))
    pdrop = 0.25 if masked else 0.0
    mask = (dropout_keep_mask(torch.Generator(device).manual_seed(1), (B, H, T, T), pdrop, device)
            if masked else None)
    return q, k, v, do, mask, pdrop


def _attention_kernel_names(dtype, D) -> tuple:
    """(forward kernel, backward kernels) that `forward_kernel` /
    `backward_kernel`'s path names at head width D: bf16 "mma" the DP <= 128
    tensor-core kernels or, past 128, the wide ones; float32 "mma_tf32x3"
    the 3xTF32 kernels at every D."""
    suffix = {"mma_tf32x3": "_tf32x3_kernel", "mma": "_mma_wide_kernel" if D > 128 else "_mma_kernel"}[
        forward_kernel(dtype, D)]
    return f"attn_fwd{suffix}", (f"attn_bwd_dq{suffix}", f"attn_bwd_dkdv{suffix}")


def _assert_attention_kernels(dtype, D, fwd: set, bwd: set) -> None:
    """The profiler's kernel names of one forward and one backward call are
    the ones the path names: one forward kernel, the backward's two."""
    assert forward_kernel(dtype, D) == backward_kernel(dtype, D)
    want_fwd, want_bwd = _attention_kernel_names(dtype, D)
    assert len(fwd) == 1 and any(want_fwd in n for n in fwd), (want_fwd, fwd)
    assert len(bwd) == 2 and all(any(w in n for n in bwd) for w in want_bwd), (want_bwd, bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,T,D", [(2, 3, 24, 8), (1, 2, 504, 256), (3, 4, 320, 48), (2, 1, 8, 33),
                                     (2, 4, 320, 16), (2, 4, 320, 128), (1, 2, 504, 128),
                                     (2, 3, 8, 129), (3, 4, 320, 192), (1, 1, 512, 256)])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_attention_matches_plain_versions(cuda_device, dtype, tol, B, H, T, D, masked):
    """The forward and backward kernels against their plain versions at odd
    shapes the gate takes (T = 8, 24, 504, 512; D = 8, 33, 129, 256) and at
    the fusion blocks' T = 320 with the first and last stage's D (16, 128)
    and a padded wide one (192), q, k, v and dO read as (B, T, H, D) views,
    with and without a p = 0.25 keep mask. bf16 runs the tensor-core
    kernels (T = 504, D = 128: the largest DP = 128 tiles and the longest
    key loop; D = 129..256 the wide kernels at DP = 256, with T tails of 8
    and 24 keys past a 32-key tile and a whole last tile at T = 512),
    float32 the 3xTF32 tensor-core ones (D = 8, 33, 129: rows copied by
    4-byte cp.async; T tails past 16-, 32- and 64-row tiles); the profiler
    names the kernels that ran. Tolerances as in `chip_smoke.py`: float32
    sums in another order (three TF32 products keep float32's accuracy);
    bf16 probabilities and score gradients rounded to bf16 on either side
    of a last-bit difference, and every bf16 result also within 2 bf16 ulps
    of max |plain|."""
    q, k, v, do, mask, pdrop = _attention_inputs(B, H, T, D, dtype, masked, cuda_device, T * D + masked)
    fwd0, bwd0 = fused_attention.launches, fused_attention_bwd.launches
    out = fused_attention(q, k, v, mask, pdrop)
    grads = fused_attention_bwd(q, k, v, mask, do, pdrop)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    assert out.shape == (B, H, T, D) and out.dtype == dtype
    want = attention_fwd_plain(q, k, v, mask, pdrop)
    _close(out, want, tol, "out")
    if dtype == torch.bfloat16:
        _within_2_bf16_ulps(out, want, "out")
    for name, got, want in zip("dq dk dv".split(), grads, attention_bwd_plain(q, k, v, mask, do, pdrop)):
        _close(got, want, tol, name)
        if dtype == torch.bfloat16:
            _within_2_bf16_ulps(got, want, name)
    # through autograd: the Function's backward is the backward kernel
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fused_attention(*leaves, mask, pdrop).backward(do)
    assert fused_attention_bwd.launches == bwd0 + 2
    for name, leaf, want in zip("dq dk dv".split(), leaves, grads):
        torch.testing.assert_close(leaf.grad, want, rtol=0, atol=0, msg=name)
    _assert_attention_kernels(dtype, D, _kernel_names(lambda: fused_attention(q, k, v, mask, pdrop)),
                              _kernel_names(lambda: fused_attention_bwd(q, k, v, mask, do, pdrop)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [64, 256])
def test_cuda_attention_backward_matches_plain_at_a_fusion_shape(cuda_device, dtype, tol, D):
    """The backward kernels (bf16 products and float32 3xTF32, both on the
    tensor cores) at one fixed fusion-block input, (2, 4, 320, D) with a keep
    mask, D = 64 and ResNet-50's stage-3 D = 256: dq, dk and dv within the
    plain versions' limits, bf16 also within 2 bf16 ulps, and the same bits
    in a second call (no atomics)."""
    q, k, v, do, mask, pdrop = _attention_inputs(2, 4, 320, D, dtype, True, cuda_device, D)
    got = fused_attention_bwd(q, k, v, mask, do, pdrop)
    again = fused_attention_bwd(q, k, v, mask, do, pdrop)
    torch.cuda.synchronize()
    for name, g1, g2, want in zip("dq dk dv".split(), got, again, attention_bwd_plain(q, k, v, mask, do, pdrop)):
        _close(g1, want, tol, name)
        if dtype == torch.bfloat16:
            _within_2_bf16_ulps(g1, want, name)
        torch.testing.assert_close(g1, g2, rtol=0, atol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 200])
def test_cuda_attention_launches_the_kernels_its_path_names(cuda_device, dtype, D):
    """`forward_kernel` / `backward_kernel` against the kernels the profiler
    sees: bf16 D = 64 the DP <= 128 tensor-core kernels, bf16 D = 200 the
    wide ones, float32 the 3xTF32 kernels at either D."""
    assert forward_kernel(dtype, D) == ("mma" if dtype == torch.bfloat16 else "mma_tf32x3")
    q, k, v, do, mask, pdrop = _attention_inputs(2, 2, 64, D, dtype, True, cuda_device, D)
    _assert_attention_kernels(dtype, D, _kernel_names(lambda: fused_attention(q, k, v, mask, pdrop)),
                              _kernel_names(lambda: fused_attention_bwd(q, k, v, mask, do, pdrop)))


@pytest.mark.cuda
def test_cuda_attention_refuses_what_the_kernel_does_not_take(cuda_device):
    """A CUDA tensor launches the kernel or raises: no plain path on the card."""
    q = torch.zeros(1, 2, 20, 16, device=cuda_device)
    with pytest.raises(ValueError, match="not supported"):
        fused_attention(q, q, q)
    q = torch.zeros(1, 2, 24, 264, device=cuda_device)
    with pytest.raises(ValueError, match="not supported"):
        fused_attention(q, q, q)
    h = torch.zeros(1, 2, 24, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        fused_attention(h, h, h)
    q = torch.zeros(1, 2, 24, 16, device=cuda_device)
    with pytest.raises(ValueError, match="mask"):
        fused_attention(q, q, q, torch.ones(1, 2, 24, 24, device=cuda_device), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,W", [(2, 20, 36), (8, 64, 256)])
def test_cuda_conv3x3_train_matches_plain_version(cuda_device, dtype, tol, B, H, W):
    """Forward and input gradient on the conv3x3 kernel the dtype picks
    (float32: `conv3x3_tf32x3_kernel`), the weight gradient from the
    library, against `conv3x3_train_plain` through autograd, at odd edges
    and where the persistent loop turns; bf16 forward and input gradient
    also within 2 bf16 ulps; the output gradient arrives in NCHW memory
    (the Function copies it to channels_last)."""
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3 as kernel

    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, H, W, 64, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
    w = to_hwio((torch.randn(64, 64, 3, 3, generator=g) * 0.05).to(cuda_device), dtype)
    dy = torch.randn(B, 64, H, W, generator=g).to(cuda_device, dtype)
    res = {}
    for name, fn in (("kernel", conv3x3_train), ("plain", conv3x3_train_plain)):
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        before = kernel.launches
        y = fn(xl, wl)
        y.backward(dy)
        torch.cuda.synchronize()
        res[name] = (y, xl.grad, wl.grad, kernel.launches - before)
    assert res["kernel"][3] == 2 and res["plain"][3] == 0
    for i, name in enumerate(("y", "dx")):
        _close(res["kernel"][i], res["plain"][i], tol, name)
        if dtype == torch.bfloat16:
            _within_2_bf16_ulps(res["kernel"][i], res["plain"][i], name)
    _close(res["kernel"][2], res["plain"][2], tol, "dw")


# --------------------------------------------------------------------------- #
# PDM simulation and scoring on the card against the CPU (plain torch, no
# hand-written kernel): the scenes of `chip_smoke.py`'s pdm_score_path phase
# --------------------------------------------------------------------------- #


def _pdm_batch(num_scenes, seed=0):
    from chip_smoke import pdm_road_cache
    from diffusiondrive_torch.common.dataclasses import Trajectory

    rng = np.random.default_rng(seed)
    caches = [pdm_road_cache(f"s{i}", seed=seed * 100 + i) for i in range(num_scenes)]
    trajs = []
    for _ in range(num_scenes):
        poses = np.zeros((8, 3), np.float32)
        steps = np.arange(1, 9)
        poses[:, 0] = rng.uniform(0.0, 14.0) * 0.5 * steps
        poses[:, 1] = rng.normal(0.0, 0.3) * steps
        poses[:, 2] = rng.normal(0.0, 0.05) * steps
        trajs.append(Trajectory(poses))
    return caches, trajs


@pytest.mark.cuda
def test_cuda_simulator_matches_cpu(cuda_device):
    """The 40-step rollout of (scenes, 2) proposals: float32 states within
    1e-3 of the CPU's, float64 within 1e-9."""
    from diffusiondrive_torch.common.dataclasses import TrajectorySampling
    from diffusiondrive_torch.evaluate.pdm_score import stack_scenes
    from diffusiondrive_torch.evaluate.simulator import PDMSimulator

    caches, trajs = _pdm_batch(6)
    sim = PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    proposals, ctx = stack_scenes(caches, trajs, sim.proposal_sampling)
    for dtype, tol in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
        p, init = torch.from_numpy(proposals).to(dtype), torch.from_numpy(ctx[0]).to(dtype)[:, None]
        want = sim.simulate_proposals(p, init)
        got = sim.simulate_proposals(p.to(cuda_device), init.to(cuda_device)).cpu()
        assert got.shape == want.shape == (6, 2, 41, 11)
        assert (got - want).abs().max().item() <= tol, dtype


@pytest.mark.cuda
@pytest.mark.parametrize("object_chunk", [16, None], ids=["chunked", "one_pass"])
def test_cuda_scorer_matches_cpu(cuda_device, object_chunk):
    """Every sub-score of both proposals on the card equals the CPU's, the
    floats within 1e-4 (`chip_smoke.pdm_outputs_match`); 96 objects in 6
    chunks or one pass; the golden scenarios hold on the card."""
    from chip_smoke import check_golden, golden_scenarios, pdm_outputs_match
    from diffusiondrive_torch.common.dataclasses import TrajectorySampling
    from diffusiondrive_torch.evaluate.pdm_score import score_scenes
    from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig, ScorerOutput, score_proposals
    from diffusiondrive_torch.evaluate.simulator import PDMSimulator

    caches, trajs = _pdm_batch(4, seed=1)
    sim = PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    config = PDMScorerConfig(object_chunk=object_chunk)
    got = score_scenes(caches, trajs, sim, config, device=cuda_device)
    want = score_scenes(caches, trajs, sim, config, device="cpu")
    pdm_outputs_match("card vs cpu", got, want)
    out = score_proposals(*[torch.from_numpy(a).to(cuda_device) for a in golden_scenarios()],
                          sim.proposal_sampling, config)
    check_golden(ScorerOutput(*[v.cpu().numpy() for v in out]))


@pytest.mark.cuda
def test_cuda_simulate_and_score_make_no_host_sync(cuda_device):
    from diffusiondrive_torch.common.dataclasses import TrajectorySampling
    from diffusiondrive_torch.evaluate.pdm_score import scenes_to_device, simulate_and_score, stack_scenes
    from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig
    from diffusiondrive_torch.evaluate.simulator import PDMSimulator

    caches, trajs = _pdm_batch(2, seed=2)
    sim = PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    proposals, ctx = scenes_to_device(*stack_scenes(caches, trajs, sim.proposal_sampling), cuda_device)
    simulate_and_score(sim, PDMScorerConfig(), proposals, *ctx)   # the constant tables reach the card once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = simulate_and_score(sim, PDMScorerConfig(), proposals, *ctx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.score.shape == (2, 2) and out.score.is_cuda


@pytest.mark.cuda
def test_cuda_pdm_closed_planner_matches_cpu(cuda_device, tmp_path):
    """One PDM-Closed call on the card against the same call on the CPU, on a
    synthetic scene of the city grid with a parked vehicle ahead: the 15
    proposals equal, the scores within 1e-4 and the choice by the tie rule
    (`chip_smoke.check_planner_choice`), the poses equal; the card's call
    makes one host sync, the scores' transfer."""
    from chip_smoke import _syncs_in, check_planner_choice, city_map
    from diffusiondrive_torch.common.dataclasses import SceneFilter
    from diffusiondrive_torch.common.dataloader import SceneLoader
    from diffusiondrive_torch.planning.pdm_closed.planner import PDMClosedPlanner
    from diffusiondrive_torch.utils.synthetic import build_synthetic_log

    logs_dir, blobs_dir = build_synthetic_log(tmp_path, num_frames=14, obstacle_x=40.0,
                                              roadblock_ids=tuple(f"rb_0_{i}" for i in range(12)))
    scene = SceneLoader(logs_dir, blobs_dir, SceneFilter(frame_interval=1), build_map_api=False).get_scene_from_token(
        "demo_log_token_00003")
    city = city_map()
    card, cpu = PDMClosedPlanner(device=cuda_device), PDMClosedPlanner(device="cpu")
    poses, _ = card.compute_planner_trajectory(scene, city)
    want, _ = cpu.compute_planner_trajectory(scene, city)
    assert card.proposals.shape == (15, 51, 11)
    np.testing.assert_array_equal(card.proposals, cpu.proposals)
    chosen = check_planner_choice("planner", card.scores, cpu.scores.astype(np.float64))
    np.testing.assert_array_equal(poses, want)
    np.testing.assert_array_equal(poses, card.proposals[chosen, :, :3])
    syncs = _syncs_in(lambda: card.compute_planner_trajectory(scene, city))
    assert len(syncs) == 1, syncs


_TINY_AGENT = ("agent.config.image_architecture=resnet34", "agent.config.lidar_architecture=resnet34",
               "agent.config.camera_height=64", "agent.config.camera_width=256",
               "agent.config.lidar_resolution_height=64", "agent.config.lidar_resolution_width=64",
               "agent.config.pixels_per_meter=1.0", "agent.config.img_vert_anchors=2",
               "agent.config.img_horz_anchors=8", "agent.config.lidar_vert_anchors=2",
               "agent.config.lidar_horz_anchors=2", "agent.config.bev_pixel_height=32",
               "agent.config.bev_pixel_width=64")


def _cli_logs(tmp_path):
    """A synthetic log with its sensor blobs on disk (a 1920x1080 JPEG, a
    binary PCD), a split of every 14-frame window, and metric caches of the
    pipeline's padded shapes (`chip_smoke.pdm_road_cache`) for its scenes."""
    from chip_smoke import pdm_road_cache
    from diffusiondrive_torch.common.dataclasses import SceneFilter
    from diffusiondrive_torch.common.dataloader import SceneLoader
    from diffusiondrive_torch.utils.synthetic import build_synthetic_log

    logs_dir, blobs_dir = build_synthetic_log(tmp_path / "data", num_frames=17, with_sensor_blobs=True)
    split = tmp_path / "split.yaml"
    split.write_text("frame_interval: 1\n")
    tokens = SceneLoader(logs_dir, blobs_dir, SceneFilter(frame_interval=1), build_map_api=False).tokens
    for i, tok in enumerate(tokens):
        pdm_road_cache(tok, seed=i).save(tmp_path / "mc" / "demo_log" / tok / "metric_cache.npz")
    return [f"navsim_log_path={logs_dir}", f"sensor_blobs_path={blobs_dir}", f"split={split}",
            f"metric_cache_path={tmp_path / 'mc'}"], tokens


@pytest.mark.cuda
@pytest.mark.parametrize("agent", [("agent=constant_velocity_agent",),
                                   ("agent=diffusiondrive_agent", "agent.dtype=float32", *_TINY_AGENT)],
                         ids=["cv", "diffusiondrive_f32"])
def test_cuda_run_pdm_score_cli_matches_cpu(cuda_device, tmp_path, agent, monkeypatch):
    """`run_pdm_score --config default_evaluation` scene-backed (sensors read
    from disk), on the card by default and with `--device cpu`: every row
    valid, the discrete sub-scores equal, the floats within 1e-4 x max(1, |CPU|).
    The agent's diffusion noise comes from one CPU draw on both devices (its
    own generator draws on the agent's device: another stream on each)."""
    import csv

    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.script import run_pdm_score

    predict = DiffusionDriveAgent.predict

    def predict_with_cpu_noise(self, tensors, diffusion_noise=None):
        shape = (tensors["status_feature"].shape[0], self.config.ego_fut_mode, self.config.num_poses, 2)
        noise = torch.randn(shape, generator=torch.Generator().manual_seed(7))
        return predict(self, tensors, diffusion_noise=noise.to(self.device))

    monkeypatch.setattr(DiffusionDriveAgent, "predict", predict_with_cpu_noise)

    data, tokens = _cli_logs(tmp_path)
    rows = {}
    for dev in ("card", "cpu"):
        argv = ["--device", "cpu"] if dev == "cpu" else []
        out = run_pdm_score.main([*argv, "--config", "default_evaluation", *agent, *data,
                                  f"output_dir={tmp_path / dev}", "batch_size=4"])
        with open(out, newline="") as fp:
            rows[dev] = list(csv.reader(fp))
    assert rows["card"][0] == rows["cpu"][0] and len(rows["card"]) == len(tokens) + 2
    floats = {rows["cpu"][0].index(c) for c in ("ego_progress", "score")}
    for got, want in zip(rows["card"][1:], rows["cpu"][1:]):
        assert got[:3] == want[:3] and got[2] == "True", (got, want)
        for j in range(3, len(got)):
            if j in floats:
                assert abs(float(got[j]) - float(want[j])) <= 1e-4 * max(1.0, abs(float(want[j]))), (got, want)
            else:
                assert got[j] == want[j], (got, want)


@pytest.mark.cuda
def test_cuda_run_training_cli_scene_backed(cuda_device, tmp_path):
    """`run_training --config default_training` on the scene-backed Dataset
    (sensors read from disk, the cache written first), float32 at the tiny
    widths, on the card by default and with `--device cpu`: finite losses,
    one row a step, a checkpoint, one LAP launch a step on the card."""
    import json

    from diffusiondrive_torch.script import run_training

    data, tokens = _cli_logs(tmp_path)
    for dev in ("card", "cpu"):
        argv = ["--device", "cpu"] if dev == "cpu" else []
        batched_linear_sum_assignment.launches = 0
        run_training.main([*argv, "--config", "default_training", *data[:3], f"cache_path={tmp_path / dev / 'c'}",
                           f"output_dir={tmp_path / dev}", "epochs=1", "batch_size=2", "precision=fp32",
                           *_TINY_AGENT])
        rows = [json.loads(r) for r in (tmp_path / dev / "metrics.jsonl").read_text().splitlines()]
        assert len(rows) == len(tokens) // 2 and all(np.isfinite(r["loss"]) for r in rows), rows
        assert (tmp_path / dev / "epoch_0000" / "state.pt").exists()
        assert batched_linear_sum_assignment.launches == (len(rows) if dev == "card" else 0)


@pytest.mark.cuda
def test_cuda_ddp_step_on_two_ranks_equals_one_rank(cuda_device, tmp_path):
    """`tests/test_torch_port_parallel.py`'s 2-rank SGD step (float64, the
    JAX dry run's tiny config and batch of 4, targets at the predictions) on
    the card: 2 ranks (NCCL over two cards, else gloo with CUDA tensors on
    one) against 1 rank on the global batch, within JAX's tiers; the ranks'
    parameters, gradients and EMA the same bits; 1 LAP launch a rank."""
    import torch_parallel_ranks as ranks

    from diffusiondrive_torch.entry import DRYRUN_CONFIG, dryrun_batch
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.parallel.distributed import launch

    cfg = TransfuserConfig(**DRYRUN_CONFIG)
    batch = ranks.placed_batch(cfg, dryrun_batch(4))
    two_cards = torch.cuda.device_count() >= 2
    out = launch(ranks.step_rank, 2, args=(cfg, batch, torch.float64), device="cuda" if two_cards else "cuda:0",
                 backend=None if two_cards else "gloo", init_method=f"file://{tmp_path / 'store'}", timeout=300)
    one = ranks.step_rank(0, 1, torch.device("cuda", 0), cfg, batch, torch.float64)
    assert one["lap"] == 1 and [o["lap"] for o in out] == [1, 1]
    assert out[0]["digest"] == out[1]["digest"] and out[0]["metrics"] == out[1]["metrics"]
    for key, want in one["metrics"].items():
        tol = 2e-3 if key == "agent_box_loss" else 3e-6
        assert abs(out[0]["metrics"][key] - want) <= tol * max(abs(want), 1e-6), key
    for k, want in one["stats"].items():
        assert (out[0]["stats"][k] - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1e-6), k
    for k, want in one["params"].items():
        assert (out[0]["params"][k] - want).abs().max().item() < 5.0 * ranks.LR, k
