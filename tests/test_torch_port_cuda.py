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
    attention_bwd_plain, attention_fwd_plain, dropout_keep_mask, fused_attention, fused_attention_bwd)
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
    """The conv3x3 kernel the dtype picks (bf16: the tensor cores, "mma";
    float32: the CUDA cores, "cuda_core"; the profiler names the kernel that
    ran) against its plain version: ragged tiles (20x36, 33x70: H and W not
    multiples of the 16x16 tile) and B=8 at 64x256 (512 tiles, more than
    the card's blocks, so the persistent loop turns), without and with the
    residual and the ReLU; bf16 also within 2 bf16 ulps; the same bits in
    two calls; one launch each."""
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
    assert path == ("mma" if dtype == torch.bfloat16 else "cuda_core")
    names = _kernel_names(lambda: fused_conv3x3(x, w, s, b, r, True))
    assert any("conv3x3_mma_kernel" in n for n in names) == (path == "mma"), names
    assert any("conv3x3_kernel" in n and "mma" not in n for n in names) == (path == "cuda_core"), names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,W,Cs,bias", [(2, 36, 100, (1, 2, 3, 4), None), (1, 68, 132, (1, 2, 3, 4), None),
                                           (2, 36, 100, (1, 2, 3, 4), -2.0), (1, 256, 1024, (3,), None)])
def test_cuda_stem_kernel_matches_plain_version(cuda_device, dtype, tol, B, H, W, Cs, bias):
    """The stem kernel the dtype picks (bf16: the tensor cores, "mma", for
    every C = 1..4; float32: the CUDA cores, "cuda_core"; the profiler names
    the kernel that ran) against its plain version: odd edges (36x100 gives
    9x25 pooled outputs, 68x132 17x33: neither a multiple of the 8x16 tile),
    a bias of -2 that drives whole regions to ReLU's zero (the pool's zero
    padding must still equal -inf padding), and the camera at B=1 (NAVSIM's
    per-scene call: 128 tiles, about one a block); bf16 also within 2 bf16
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
    assert path == ("mma" if dtype == torch.bfloat16 else "cuda_core")
    names = _kernel_names(lambda: fused_stem(x, w, s, b))
    assert any("stem_mma_kernel" in n for n in names) == (path == "mma"), names
    assert any("stem_kernel" in n and "mma" not in n for n in names) == (path == "cuda_core"), names


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,T,D", [(2, 3, 24, 8), (1, 2, 504, 256), (3, 4, 320, 48), (2, 1, 8, 33),
                                     (2, 4, 320, 16), (2, 4, 320, 128), (1, 2, 504, 128)])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_attention_matches_plain_versions(cuda_device, dtype, tol, B, H, T, D, masked):
    """The forward and backward kernels against their plain versions at odd
    shapes the gate takes (T = 8, 24, 504; D = 8, 33, 256) and at the
    fusion blocks' T = 320 with the first and last stage's D (16, 128), q,
    k, v and dO read as (B, T, H, D) views, with and without a p = 0.25
    keep mask. bf16 with D <= 128 runs the tensor-core kernels (T = 504,
    D = 128: the largest tiles and the longest key loop), D = 256 and
    float32 the CUDA-core ones. Tolerances as in `chip_smoke.py`: float32
    sums in another order; bf16 probabilities and score gradients rounded to
    bf16 on either side of a last-bit difference, and every bf16 result also
    within 2 bf16 ulps of max |plain|."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_attention_backward_matches_plain_at_a_fusion_shape(cuda_device, dtype, tol):
    """The backward kernels (bf16 on the tensor cores, float32 on the CUDA
    cores) at one fixed fusion-block input, (2, 4, 320, 64) with a keep
    mask: dq, dk and dv within the plain versions' limits, bf16 also within
    2 bf16 ulps, and the same bits in a second call (no atomics)."""
    q, k, v, do, mask, pdrop = _attention_inputs(2, 4, 320, 64, dtype, True, cuda_device, 64)
    got = fused_attention_bwd(q, k, v, mask, do, pdrop)
    again = fused_attention_bwd(q, k, v, mask, do, pdrop)
    torch.cuda.synchronize()
    for name, g1, g2, want in zip("dq dk dv".split(), got, again, attention_bwd_plain(q, k, v, mask, do, pdrop)):
        _close(g1, want, tol, name)
        if dtype == torch.bfloat16:
            _within_2_bf16_ulps(g1, want, name)
        torch.testing.assert_close(g1, g2, rtol=0, atol=0, msg=name)


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
    """Forward and input gradient on the conv3x3 kernel, the weight gradient
    from the library, against `conv3x3_train_plain` through autograd, at odd
    edges and where the persistent loop turns; bf16 forward and input
    gradient also within 2 bf16 ulps; the output gradient arrives in NCHW
    memory (the Function copies it to channels_last)."""
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
