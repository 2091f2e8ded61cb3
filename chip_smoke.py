#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It drives
`diffusiondrive_torch` only (never JAX or the JAX package) and prints one
line per phase, then one JSON line per kernel summary, then the result:

1. ``device``  the card's name and power limit (nvidia-smi).
2. ``build``   builds every CUDA kernel from `diffusiondrive_torch/csrc/`
               with nvcc for sm_90a (one nvcc per source, in parallel) into
               `diffusiondrive_torch/_build/`; prints seconds and ptxas stats.
3. ``kernel``  each kernel at its main-path shapes (B=16; the conv kernels in
               bf16 and f32) against its plain PyTorch version (max abs error
               and the tolerance; the lidar splat must be exact), timed with
               CUDA events beside the plain version, a library yardstick
               (`library_ms`, never used by the port) and the card's bound
               for the same work (`bound_ms`).
4. ``main_path`` the full-width planner forward (default TransfuserConfig,
               seeded random weights): (a) float32 at B=1 on the card against
               the same model on the CPU; (b) bf16 at B=1 and B=16, finite
               outputs and frames/s. The kernel launch counters are set to 0
               before this phase and must read 2 stem and 12 conv3x3 launches
               per forward after it.
5. ``agent_path`` the raw-sensor agent (`DiffusionDriveAgent(
               preprocess_on_device=True)`, full width): (a) float32 at B=1 on
               the card against the same agent on the CPU (stitched camera,
               BEV and every output); (b) bf16 `compute_trajectory` at B=1 and
               `forward` at B=16: finite outputs, frames/s with the inputs
               already on the card and with the host-to-device copy, the copy's
               ms on its own line, peak memory. The counters are set to 0
               before this phase and must read 1 splat, 2 stem and 12 conv3x3
               launches per agent forward after it.
6. ``kernel lap b8`` / ``b64`` the batched Hungarian kernel at n=30 (float32
               costs from a seed, half of each batch integer costs in [0, 4)
               for ties): its assignment equals the plain version's on the
               card exactly and its total cost scipy's within 1e-5 relative;
               kernel_ms, plain_ms, library_ms (scipy on the host, with the
               copy: no PyTorch call solves an assignment), bound_ms and
               ptxas registers/spills; the kernel makes no host sync
               (`torch.cuda.set_sync_debug_mode`).
7. ``train_path`` the training path at full width. (a) ``bf16``: `Trainer.fit` over a
               `CacheOnlyDataset` of 3*B seeded samples at B=8 and B=64 (two
               epochs: the second is timed; validation of the weights and of
               the EMA; a checkpoint): steps/s, samples/s, ms per step, peak
               memory, the loss terms (all finite), host syncs in one train
               step (`torch.cuda.set_sync_debug_mode`). The counters are set
               to 0 just before each fit and read just after it; they must
               read exactly 1 LAP launch per train step and per validation
               forward, no stem or conv3x3 launch in a train epoch, and
               2 stem + 12 conv3x3 per validation forward; the path's count
               is their sum over both fits.
               (b) ``f32``: one float32 train step at B=2 on the card
               against the same step on the CPU, with a float64 step on
               each as the witness (same seeded weights and inputs, dropout
               off, fixed timesteps and noise, targets placed at the
               predictions so the detection assignment is unique): every loss term within
               1e-3 x max(1, |CPU|); per parameter, the card's float64
               gradient within 1e-6 relative L2 of the CPU's, and the
               card's float32 gradient within min(1e-2 + 2 x the CPU f32
               gradient's distance, 0.1) of the CPU's float64 one (reason
               in `phase_train_f32`); the BN running statistics within
               1e-4 x max(1, |CPU|). Logs where the float32 steps leave the
               float64 one, by module (forward) and by part (gradients).
8. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Any failure raises and exits non-zero; without a CUDA device it exits 2
before printing any result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Tolerances are relative: the limit on max |got - want| is tol * max(1, max |want|).
# float32: sums in another order. bf16: the plain version rounds the conv to
# bf16 before the affine, the kernel keeps it in f32 (one bf16 ulp apart).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # kernel vs plain
MAIN_TOL = 1e-3            # card f32 forward vs CPU f32 forward


def log(phase: str, **fields) -> None:
    print(phase + ": " + json.dumps(fields), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype):
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nhwc_randn(shape, gen, device, dtype):
    """(B, H, W, C) normal draw -> NCHW view in channels_last memory."""
    return torch.randn(shape, generator=gen).to(device, dtype).permute(0, 3, 1, 2)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float):
    """(max abs error, its limit tol * max(1, max |want|)); raises past the limit."""
    err = (got.float() - want.float()).abs().max().item()
    limit = tol * max(1.0, want.float().abs().max().item())
    if not err <= limit:
        raise AssertionError(f"{name}: max abs err {err} > limit {limit}")
    return err, limit


def phase_device() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(out.splitlines()[0], flush=True)
    log("device", nvidia_smi=out.splitlines()[0], torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return out


def phase_build() -> dict:
    from diffusiondrive_torch.ops import _build

    t0 = time.time()
    logs = _build.build_all()
    missing = [n for n in _build.kernel_names() if not _build._target(n).exists()]
    if missing:
        raise RuntimeError(f"kernel libraries not built: {missing}")
    stats = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.time() - t0, 3), built=sorted(logs),
        kernels=_build.kernel_names(), ptxas=stats[:24])
    return logs


def phase_kernels(dev) -> dict:
    from diffusiondrive_torch.ops.conv_fused import conv3x3_plain, fused_conv3x3, to_hwio
    from diffusiondrive_torch.ops.stem_fused import fused_stem, stem_plain

    gen = torch.Generator().manual_seed(0)
    s = (torch.rand(64, generator=gen) + 0.5).to(dev)
    b = (torch.randn(64, generator=gen) * 0.1).to(dev)
    summary = {}

    for label, shape in (("camera", (16, 256, 1024, 3)), ("lidar", (16, 256, 256, 1))):
        B, H, W, C = shape
        w_oihw = (torch.randn(64, C, 7, 7, generator=gen) / (49 * C) ** 0.5).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = nhwc_randn(shape, gen, dev, dtype)
            w = to_hwio(w_oihw, dtype)   # laid out once, as the model does
            got, want = fused_stem(x, w, s, b), stem_plain(x, w, s, b)
            torch.cuda.synchronize()
            err, limit = check_close(f"stem {label} {dtype}", got, want, TOL[dtype])
            wf = (w_oihw * s[:, None, None, None]).to(dtype)
            bf = b.to(dtype)
            esize = x.element_size()
            flops = 2.0 * B * (H // 2) * (W // 2) * 64 * 49 * C
            nbytes = esize * (B * H * W * C + B * (H // 4) * (W // 4) * 64 + 49 * C * 64) + 2 * 64 * 4
            bms, by = bound_ms(flops, nbytes, dtype)
            row = dict(shape=list(shape), dtype=str(dtype), max_abs_err=err, limit=limit,
                       kernel_ms=time_ms(lambda: fused_stem(x, w, s, b)),
                       plain_ms=time_ms(lambda: stem_plain(x, w, s, b)),
                       library_ms=time_ms(lambda: F.max_pool2d(
                           torch.relu_(F.conv2d(x, wf, bf, stride=2, padding=3)), 3, 2, 1)),
                       bound_ms=bms, bound_by=by)
            log(f"kernel stem {label}", **row)
            summary[("stem", label, dtype)] = row

    for label, shape in (("image", (16, 64, 256, 64)), ("lidar", (16, 64, 64, 64))):
        B, H, W, _ = shape
        w_oihw = (torch.randn(64, 64, 3, 3, generator=gen) / 24.0).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = nhwc_randn(shape, gen, dev, dtype)
            r = nhwc_randn(shape, gen, dev, dtype)
            w = to_hwio(w_oihw, dtype)
            wf = (w_oihw * s[:, None, None, None]).to(dtype)
            bf = b.to(dtype)
            for res in (None, r):
                got = fused_conv3x3(x, w, s, b, res, relu=True)
                want = conv3x3_plain(x, w, s, b, res, relu=True)
                torch.cuda.synchronize()
                variant = "residual" if res is not None else "no_residual"
                err, limit = check_close(f"conv3x3 {label} {variant} {dtype}", got, want,
                                         TOL[dtype])
                esize = x.element_size()
                flops = 2.0 * B * H * W * 64 * 576
                nbytes = esize * (B * H * W * 64 * (2 + (res is not None)) + 576 * 64) + 2 * 64 * 4
                bms, by = bound_ms(flops, nbytes, dtype)
                if res is None:
                    lib = lambda: torch.relu_(F.conv2d(x, wf, bf, padding=1))  # noqa: E731
                else:
                    lib = lambda: torch.relu_(F.conv2d(x, wf, bf, padding=1).add_(r))  # noqa: E731
                row = dict(shape=list(shape), dtype=str(dtype), variant=variant, max_abs_err=err,
                           limit=limit,
                           kernel_ms=time_ms(lambda: fused_conv3x3(x, w, s, b, res, relu=True)),
                           plain_ms=time_ms(lambda: conv3x3_plain(x, w, s, b, res, relu=True)),
                           library_ms=time_ms(lib), bound_ms=bms, bound_by=by)
                log(f"kernel conv3x3 {label} {variant}", **row)
                summary[("conv3x3", label, variant, dtype)] = row

    summary.update(phase_lidar_splat(dev))
    return summary


def phase_lidar_splat(dev) -> dict:
    """The splat kernel at the agent path's batches against its plain version:
    exact, and the same in two runs. Seeded clouds (`example_point_cloud`)
    with hot bins next to the ego, points beyond +-32 m, above
    `max_height_lidar` and below the split plane, points on the bin edges,
    and padding."""
    from diffusiondrive_torch.entry import example_point_cloud
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.lidar_splat import _bin_indices, histogram2d, histogram2d_plain
    from diffusiondrive_torch.ops.preprocessing import pad_point_cloud

    cfg = TransfuserConfig()
    N, bins = 131072, cfg.lidar_resolution_width
    rng = np.random.default_rng(3)
    clouds = [pad_point_cloud(example_point_cloud(rng, N - 2048 * b, cfg), N) for b in range(16)]
    points = torch.from_numpy(np.stack([p for p, _ in clouds])).to(dev)
    valid = torch.from_numpy(np.stack([v for _, v in clouds])).to(dev)
    keep = valid & (points[..., 2] < cfg.max_height_lidar) & (points[..., 2] > cfg.lidar_split_height)
    ix, iy = _bin_indices(points[..., :2], keep, cfg.lidar_min_x, cfg.lidar_max_x,
                          cfg.lidar_min_y, cfg.lidar_max_y, bins)
    summary = {}
    for B in (16, 1):
        bx, by = ix[:B].contiguous(), iy[:B].contiguous()
        got, again, want = histogram2d(bx, by, bins), histogram2d(bx, by, bins), histogram2d_plain(bx, by, bins)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if err != 0 or not torch.equal(got, again):
            raise AssertionError(f"lidar_splat B={B}: max abs err {err} (must be 0), "
                                 f"repeatable {torch.equal(got, again)}")
        if not torch.equal(want.cpu(), histogram2d_plain(bx.cpu(), by.cpu(), bins)):
            raise AssertionError(f"lidar_splat B={B}: plain version differs between card and CPU")
        # library yardstick: one scatter_add_ of ones into a (B*bins^2 + 1) buffer, skipped
        # points into the last (overflow) bucket, as `histogram2d_jax` does
        ok = bx >= 0
        batch = torch.arange(B, device=dev)[:, None] * bins * bins
        flat = torch.where(ok, batch + bx.long() * bins + by.long(), B * bins * bins).flatten()
        ones = torch.ones(flat.shape, device=dev)
        buf = torch.zeros(B * bins * bins + 1, device=dev)
        nbytes = 8.0 * B * N + 4.0 * B * bins * bins
        bms, by_what = bound_ms(0.0, nbytes, torch.float32)
        row = dict(shape=[B, N], bins=bins, points_counted=int(ok.sum().item()),
                   hottest_bin=int(want.max().item()), max_abs_err=err,
                   kernel_ms=time_ms(lambda: histogram2d(bx, by, bins)),
                   plain_ms=time_ms(lambda: histogram2d_plain(bx, by, bins)),
                   library_ms=time_ms(lambda: buf.scatter_add_(0, flat, ones)),
                   bound_ms=bms, bound_by=by_what)
        log(f"kernel lidar_splat b{B}", **row)
        summary[("lidar_splat", B)] = row
    return summary


def _outputs_ok(out: dict, batch: int) -> None:
    shapes = {"trajectory": (batch, 8, 3), "poses_reg": (batch, 20, 8, 3), "poses_cls": (batch, 20),
              "agent_states": (batch, 30, 5), "agent_labels": (batch, 30),
              "bev_semantic_map": (batch, 128, 256, 7)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
        if not torch.isfinite(out[k].float()).all():
            raise AssertionError(f"{k}: non-finite values")


def phase_main_path(dev) -> dict:
    from diffusiondrive_torch.entry import build_model, example_inputs
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.stem_fused import fused_stem

    cfg = TransfuserConfig()
    cpu = torch.device("cpu")
    noise = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, cfg.ego_fut_mode, cfg.num_poses, 2)).astype(np.float32))
    model_cpu = build_model(cfg, torch.float32, seed=0)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    inputs_cpu = example_inputs(cfg, 1, cpu, seed=1)
    inputs_gpu = {k: v.to(dev) for k, v in inputs_cpu.items()}

    fused_stem.launches = 0
    fused_conv3x3.launches = 0
    forwards = 0
    with torch.no_grad():
        # (a) float32, B=1: card with the kernels vs CPU with the plain versions
        out_gpu = model_gpu(**inputs_gpu, diffusion_noise=noise.to(dev))
        torch.cuda.synchronize()
        forwards += 1
        if (fused_stem.launches, fused_conv3x3.launches) != (2, 12):
            raise AssertionError(f"f32 forward launched {fused_stem.launches} stem and "
                                 f"{fused_conv3x3.launches} conv3x3 kernels, want 2 and 12")
        out_cpu = model_cpu(**inputs_cpu, diffusion_noise=noise)
        _outputs_ok(out_gpu, 1)
        errs = {k: check_close(f"main_path f32 {k}", out_gpu[k].cpu(), out_cpu[k], MAIN_TOL)[0]
                for k in out_cpu}
        cls = out_cpu["poses_cls"][0]
        top2 = cls.topk(2).values
        same_mode = int(out_gpu["poses_cls"].argmax(-1).item()) == int(cls.argmax().item())
        if not same_mode:
            raise AssertionError(f"argmax mode differs (CPU top-2 cls gap {float(top2[0] - top2[1])})")
        log("main_path f32 b1 card-vs-cpu", max_abs_err=errs, tol_rel=MAIN_TOL, argmax_equal=same_mode,
            cpu_top2_gap=float(top2[0] - top2[1]))
        del model_gpu, out_gpu

        # (b) bf16 at B=1 and B=16: finite outputs, frames/s
        model = build_model(cfg, torch.bfloat16, seed=0).to(dev)
        gen = torch.Generator(device=dev)
        fps = {}
        for batch, iters in ((1, 20), (16, 10)):
            inputs = example_inputs(cfg, batch, dev, seed=2)
            for _ in range(2):
                out = model(**inputs, generator=gen.manual_seed(0))
            torch.cuda.synchronize()
            _outputs_ok(out, batch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(iters):
                out = model(**inputs, generator=gen.manual_seed(0))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            forwards += 2 + iters
            fps[batch] = batch * iters / dt
            log(f"main_path bf16 b{batch}", frames_per_s=fps[batch], ms_per_forward=dt / iters * 1e3,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    counts = {"stem": fused_stem.launches, "conv3x3": fused_conv3x3.launches}
    if counts != {"stem": 2 * forwards, "conv3x3": 12 * forwards}:
        raise AssertionError(f"launch counts {counts} over {forwards} forwards, want 2 and 12 each")
    log("main_path launches", forwards=forwards, **counts)
    return counts


def phase_agent_path(dev) -> dict:
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.agents.diffusiondrive.features import RawSensorFeatureBuilder
    from diffusiondrive_torch.entry import agent_entry, example_agent_input
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.ops.stem_fused import fused_stem

    cfg = TransfuserConfig()
    builder = RawSensorFeatureBuilder(cfg)
    fused_stem.launches = fused_conv3x3.launches = histogram2d.launches = 0
    forwards = 0
    with torch.no_grad():
        # (a) float32, B=1: the agent on the card against the same agent on the CPU, one
        # fixed noise draw for both (each device's generator draws its own)
        agents = {d: DiffusionDriveAgent(cfg, dtype=torch.float32, seed=0, preprocess_on_device=True,
                                         device=d) for d in ("cpu", dev)}
        feats = {k: np.asarray(v)[None] for k, v in
                 builder.compute_features(example_agent_input(cfg, seed=1)).items()}
        noise = torch.from_numpy(np.random.default_rng(0).normal(
            size=(1, cfg.ego_fut_mode, cfg.num_poses, 2)).astype(np.float32))
        res = {}
        for d, agent in agents.items():
            agent.initialize()
            t = agent.features_to_device(feats)
            camera, bev = agent.preprocess(t)
            out = agent.model(camera, bev, t["status_feature"], diffusion_noise=noise.to(agent.device))
            res[d] = (camera.cpu(), bev.cpu(), {k: v.cpu() for k, v in out.items()})
        torch.cuda.synchronize()
        forwards += 1
        (cam_c, bev_c, out_c), (cam_g, bev_g, out_g) = res["cpu"], res[dev]
        cam_err = (cam_g - cam_c).abs().max().item()
        if not cam_err <= 1e-6 or not torch.equal(bev_g, bev_c):
            raise AssertionError(f"agent_path f32: camera err {cam_err} (limit 1e-6), BEV exact "
                                 f"{torch.equal(bev_g, bev_c)}")
        _outputs_ok(out_g, 1)
        errs = {k: check_close(f"agent_path f32 {k}", out_g[k], out_c[k], MAIN_TOL)[0] for k in out_c}
        cls = out_c["poses_cls"][0]
        top2 = cls.topk(2).values
        if int(out_g["poses_cls"].argmax(-1).item()) != int(cls.argmax().item()):
            raise AssertionError(f"agent_path argmax mode differs (CPU top-2 gap {float(top2[0] - top2[1])})")
        log("agent_path f32 b1 card-vs-cpu", camera_max_abs_err=cam_err, bev_exact=True,
            max_abs_err=errs, tol_rel=MAIN_TOL, argmax_equal=True, cpu_top2_gap=float(top2[0] - top2[1]))
        del agents, res

        # (b) bf16: compute_trajectory at B=1, forward at B=16
        agent, agent_input = agent_entry(dev, torch.bfloat16, seed=0)
        for _ in range(2):
            traj = agent.compute_trajectory(agent_input)
        forwards += 2
        if traj.poses.shape != (cfg.num_poses, 3) or not np.isfinite(traj.poses).all():
            raise AssertionError(f"compute_trajectory: {traj.poses.shape}, finite "
                                 f"{np.isfinite(traj.poses).all()}")
        batches = {1: {k: np.asarray(v)[None] for k, v in builder.compute_features(agent_input).items()}}
        many = [builder.compute_features(example_agent_input(cfg, seed=100 + b)) for b in range(16)]
        batches[16] = {k: np.stack([f[k] for f in many]) for k in many[0]}
        del many
        rows = {}
        for batch, iters in ((1, 10), (16, 5)):
            features = batches[batch]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                tensors = agent.features_to_device(features)
            torch.cuda.synchronize()
            h2d_ms = (time.perf_counter() - t0) / iters * 1e3
            for _ in range(2):
                out = agent.predict(tensors)
            torch.cuda.synchronize()
            _outputs_ok(out, batch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(iters):
                out = agent.predict(tensors)
            torch.cuda.synchronize()
            dev_s = (time.perf_counter() - t0) / iters
            t0 = time.perf_counter()
            for _ in range(iters):
                if batch == 1:
                    traj = agent.compute_trajectory(agent_input)
                else:
                    out_np = agent.forward(features)
            e2e_s = (time.perf_counter() - t0) / iters
            forwards += 2 * iters + 2
            if batch == 16:
                _outputs_ok({k: torch.from_numpy(v) for k, v in out_np.items()}, batch)
            rows[batch] = dict(
                call="compute_trajectory" if batch == 1 else "forward",
                frames_per_s_on_card=batch / dev_s, ms_per_call_on_card=dev_s * 1e3,
                frames_per_s_with_copy=batch / e2e_s, ms_per_call_with_copy=e2e_s * 1e3,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            log(f"agent_path h2d b{batch}", ms_per_call=h2d_ms,
                mbytes=sum(v.nbytes for v in features.values()) / 1e6)
            log(f"agent_path bf16 b{batch}", **rows[batch])
    counts = {"splat": histogram2d.launches, "stem": fused_stem.launches,
              "conv3x3": fused_conv3x3.launches}
    if counts != {"splat": forwards, "stem": 2 * forwards, "conv3x3": 12 * forwards}:
        raise AssertionError(f"launch counts {counts} over {forwards} agent forwards, "
                             f"want 1 splat, 2 stem and 12 conv3x3 each")
    log("agent_path launches", forwards=forwards, **counts)
    return counts


def phase_lap(dev, build_logs: dict) -> dict:
    """The LAP kernel at n=30, B=8 and B=64, against its plain version on the
    card (exact) and scipy on the host (total cost)."""
    from scipy.optimize import linear_sum_assignment

    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment, linear_sum_assignment_plain

    ptxas = [ln.strip() for ln in build_logs.get("lap", "").splitlines()
             if "registers" in ln or "spill" in ln]
    n = 30
    rng = np.random.default_rng(30)
    summary = {}
    for B in (8, 64):
        costs = rng.normal(size=(B, n, n)).astype(np.float32)
        costs[B // 2:] = rng.integers(0, 4, size=(B - B // 2, n, n))  # ties
        c = torch.from_numpy(costs).to(dev)
        got, want = batched_linear_sum_assignment(c), linear_sum_assignment_plain(c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"lap B={B}: kernel assignment differs from the plain version's")
        syncs = _syncs_in(lambda: batched_linear_sum_assignment(c))
        if syncs:
            raise AssertionError(f"lap B={B}: the assignment synchronised with the host: {syncs}")
        worst = 0.0
        for cb, col in zip(costs, got.cpu().numpy()):
            r, cs = linear_sum_assignment(cb)
            opt = cb[r, cs].sum(dtype=np.float64)
            worst = max(worst, abs(cb[np.arange(n), col].sum(dtype=np.float64) - opt) / max(1.0, abs(opt)))
        if not worst <= 1e-5:
            raise AssertionError(f"lap B={B}: total cost {worst} relative above scipy's optimum")

        def scipy_host():
            host = c.cpu().numpy()  # the copy and the sync the reference pays every step
            return [linear_sum_assignment(x)[1] for x in host]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            scipy_host()
        library_ms = (time.perf_counter() - t0) / 10 * 1e3
        bms, by = bound_ms(0.0, 4.0 * B * n * n + 4.0 * B * n, torch.float32)
        row = dict(shape=[B, n, n], ties_in=f"{B - B // 2} of {B} problems", max_abs_err=0, host_syncs=0,
                   scipy_max_rel_cost_gap=worst,
                   kernel_ms=time_ms(lambda: batched_linear_sum_assignment(c)),
                   plain_ms=time_ms(lambda: linear_sum_assignment_plain(c), iters=3, warmup=1),
                   library_ms=library_ms, library="scipy.optimize.linear_sum_assignment on the host, "
                   "with the device-to-host copy (not a PyTorch call)",
                   bound_ms=bms, bound_by=by, dependent_warp_argmins=n * (n + 1), ptxas=ptxas)
        log(f"kernel lap b{B}", **row)
        summary[("lap", B)] = row
    return summary


def _quantiles(vals) -> dict:
    v = np.sort(np.asarray(list(vals)))
    return {"median": float(np.median(v)), "p90": float(v[int(0.9 * (len(v) - 1))]), "max": float(v[-1])}


# the model's parts, in the order the backward reaches them
_GRAD_GROUPS = ("trajectory_head", "agent_head", "bev_semantic", "tf_decoder", "bev_proj", "keyval_embedding",
                "query_embedding", "status_encoding", "bev_downscale", "backbone.up_conv", "backbone.c5_conv",
                "backbone.fusion3", "backbone.fusion2", "backbone.fusion1", "backbone.fusion0",
                "backbone.image_encoder_layer4", "backbone.lidar_encoder_layer4",
                "backbone.image_encoder_layer3", "backbone.lidar_encoder_layer3",
                "backbone.image_encoder_layer2", "backbone.lidar_encoder_layer2",
                "backbone.image_encoder_layer1", "backbone.lidar_encoder_layer1",
                "backbone.image_encoder_stem", "backbone.lidar_encoder_stem")


def _by_group(dist: dict) -> dict:
    """Median of a per-parameter distance over each part of the model."""
    out = {}
    for g in _GRAD_GROUPS:
        vals = [v for k, v in dist.items() if k.startswith(g)]
        if vals:
            out[g] = float(np.median(vals))
    return out


def _first_above(dist: dict, limit: float):
    return next(((k, v) for k, v in dist.items() if v > limit), None)


def phase_train_f32(dev) -> None:
    """One float32 train step at full width, B=2: the card against the CPU,
    with a float64 step on each as the witness (`entry.train_step_on`).

    Loss terms: card f32 vs CPU f32 within 1e-3 x max(1, |CPU|). Gradients,
    per parameter by relative L2 (`entry.grad_distances`): card f64 vs CPU
    f64 within 1e-6 (the card's arithmetic, with the conditioning of the
    model taken out), and card f32 vs CPU f64 within min(1e-2 + 2 x the CPU
    f32 step's own distance to it, 0.1): the card's float32 step is held to
    the CPU's float32 accuracy against the same float64 reference. The
    float32 gradient of a train-mode BatchNorm network is a sum with heavy
    cancellation (the BN backward subtracts the batch mean of the incoming
    gradient), so at full width it sits percents from the float64 one on
    every device (PERF.md, PR 3). BN running statistics: card f32 vs CPU f32
    within 1e-4 x max(1, |CPU|). Every run reads the same inputs
    (`entry.comparison_batch`, the camera normalised on the host). Also
    logged: the card f32 step with cuDNN off, and where each step's forward
    outputs leave the float64 ones, module by module.
    """
    from diffusiondrive_torch.entry import (
        build_model, comparison_batch, grad_distances, output_distances, train_step_on)
    from diffusiondrive_torch.models.config import TransfuserConfig

    cfg = TransfuserConfig()
    model = build_model(cfg, torch.float32, seed=0).train()
    batch, ts, noise = comparison_batch(model, cfg, 2, seed=5)
    cpu = torch.device("cpu")
    runs = {}
    for label, d, dtype, cudnn in (("card_f32", dev, torch.float32, True), ("card_f64", dev, torch.float64, True),
                                   ("card_f32_no_cudnn", dev, torch.float32, False),
                                   ("cpu_f32", cpu, torch.float32, True), ("cpu_f64", cpu, torch.float64, True)):
        t0 = time.perf_counter()
        runs[label] = train_step_on(model, cfg, batch, ts, noise, d, dtype, cudnn=cudnn, record=True)
        runs[label]["seconds"] = time.perf_counter() - t0
        if d.type == "cuda" and runs[label]["lap_launches"] != 1:
            raise AssertionError(f"train_path {label}: {runs[label]['lap_launches']} LAP launches, want 1")
    ref = runs["cpu_f64"]
    grads = {k: grad_distances(r["grads"], ref["grads"]) for k, r in runs.items() if k != "cpu_f64"}
    outs = {k: output_distances(r["outputs"], ref["outputs"]) for k, r in runs.items() if k != "cpu_f64"}
    lc, lg = runs["cpu_f32"]["losses"], runs["card_f32"]["losses"]
    loss_err = {k: abs(lg[k] - v) for k, v in lc.items()}
    sc, sg = runs["cpu_f32"]["stats"], runs["card_f32"]["stats"]
    bn_err = max((sg[k] - b).abs().max().item() / max(1.0, b.abs().max().item()) for k, b in sc.items())
    limit = {k: min(1e-2 + 2.0 * v, 0.1) for k, v in grads["cpu_f32"].items()}
    over = {k: v / limit[k] for k, v in grads["card_f32"].items()}
    worst = max(over, key=over.get)
    worst64 = max(grads["card_f64"], key=grads["card_f64"].get)
    log("train_path f32 b2 card-vs-cpu", losses_cpu=lc, loss_max_abs_err=loss_err, params=len(ref["grads"]),
        seconds={k: r["seconds"] for k, r in runs.items()},
        grad_rel_l2_vs_cpu_f64={k: _quantiles(v.values()) for k, v in grads.items()},
        grad_worst_param=worst, grad_worst_rel_l2=grads["card_f32"][worst], grad_worst_limit=limit[worst],
        grad_card_f64_worst=[worst64, grads["card_f64"][worst64]], bn_stats_max_rel_err=bn_err,
        bn_tensors=len(sc))
    log("train_path f32 b2 losses", **{k: r["losses"] for k, r in runs.items()})
    log("train_path f32 b2 grads by part vs cpu_f64", order="backward", **{k: _by_group(v) for k, v in grads.items()})
    log("train_path f32 b2 forward outputs vs cpu_f64", modules=len(outs["cpu_f32"]), order="forward", **{
        k: {"first_above": {f"{t:g}": _first_above(v, t) for t in (1e-12, 1e-9, 1e-7, 1e-5, 1e-4)},
            "worst": max(v.items(), key=lambda kv: kv[1])} for k, v in outs.items()})
    for k, v in lc.items():
        if not loss_err[k] <= 1e-3 * max(1.0, abs(v)):
            raise AssertionError(f"train_path f32 {k}: card {lg[k]} vs CPU {v}")
    if not grads["card_f64"][worst64] <= 1e-6:
        raise AssertionError(f"train_path f64 grad {worst64}: card vs CPU relative L2 {grads['card_f64'][worst64]}")
    if not over[worst] <= 1.0:
        raise AssertionError(f"train_path f32 grad {worst}: relative L2 to the CPU's float64 step "
                             f"{grads['card_f32'][worst]} > {limit[worst]}")
    if not bn_err <= 1e-4:
        raise AssertionError(f"train_path f32 BN running statistics: max rel err {bn_err} > 1e-4")


class _Counts:
    """Trainer callback: the kernel launch counters at each epoch's start and
    end, by phase."""

    def __init__(self):
        from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
        from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
        from diffusiondrive_torch.ops.stem_fused import fused_stem

        self.fns = {"lap": batched_linear_sum_assignment, "stem": fused_stem, "conv3x3": fused_conv3x3}
        self.delta = {}
        self.wall = {}
        self._start = {}

    def _now(self):
        return {k: f.launches for k, f in self.fns.items()}

    def on_epoch_start(self, phase, epoch):
        torch.cuda.synchronize()
        self._start[phase] = (self._now(), time.perf_counter())

    def on_epoch_end(self, phase, epoch):
        torch.cuda.synchronize()
        counts, t0 = self._start[phase]
        self.wall[(phase, epoch)] = time.perf_counter() - t0
        self.delta[(phase, epoch)] = {k: v - counts[k] for k, v in self._now().items()}


def _syncs_in(fn) -> list:
    """The synchronising calls `fn` makes, as `set_sync_debug_mode("warn")`
    reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0][:160] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def phase_train_bf16(dev) -> dict:
    """`Trainer.fit` in bf16 at full width over a seeded cache, B=8 and B=64."""
    from diffusiondrive_torch.agents.diffusiondrive.features import (
        TransfuserFeatureBuilder, TransfuserTargetBuilder)
    from diffusiondrive_torch.entry import build_model, write_example_cache
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.training.dataset import CacheOnlyDataset, batch_iterator
    from diffusiondrive_torch.training.train import OptimizerConfig, train_step
    from diffusiondrive_torch.training.trainer import Trainer

    cfg = TransfuserConfig()
    launches = {}
    for B in (8, 64):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            t0 = time.perf_counter()
            write_example_cache(Path(tmp) / "cache", cfg, 3 * B, seed=B)
            cache_s = time.perf_counter() - t0
            ds = CacheOnlyDataset(str(Path(tmp) / "cache"), [TransfuserFeatureBuilder(cfg)],
                                  [TransfuserTargetBuilder(cfg)])
            counts = _Counts()
            opt = OptimizerConfig(epochs=2, warmup_epochs=1, steps_per_epoch=3, ema_decay=0.999)
            trainer = Trainer(build_model(cfg, torch.bfloat16, seed=0).to(dev), cfg, opt,
                              output_dir=str(Path(tmp) / "out"), seed=0, callbacks=[counts])
            torch.cuda.reset_peak_memory_stats()
            for f in counts.fns.values():
                f.launches = 0
            trainer.fit(lambda epoch: batch_iterator(ds, B, seed=epoch), 2,
                        val_batches=lambda epoch: batch_iterator(ds, B, shuffle=False),
                        validate_every_epochs=2, checkpoint_every_epochs=2)
            torch.cuda.synchronize()
            fit_counts = counts._now()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if not (Path(tmp) / "out" / "epoch_0001" / "state.pt").exists():
                raise AssertionError(f"train_path bf16 b{B}: no checkpoint written")
            train_rows = [json.loads(ln) for ln in (Path(tmp) / "out" / "metrics.jsonl").read_text().splitlines()
                          if '"train"' in ln]
            if len(train_rows) != 6 or not all(np.isfinite(v) for r in train_rows for v in r.values()
                                               if isinstance(v, float)):
                raise AssertionError(f"train_path bf16 b{B}: metrics rows {train_rows}")
            val = trainer.last_val_metrics
            if not val or not all(np.isfinite(v) for v in val.values()):
                raise AssertionError(f"train_path bf16 b{B}: validation metrics {val}")
            for epoch in (0, 1):
                if counts.delta[("train", epoch)] != {"lap": 3, "stem": 0, "conv3x3": 0}:
                    raise AssertionError(f"train_path bf16 b{B} train epoch {epoch}: launches "
                                         f"{counts.delta[('train', epoch)]}, want 3 LAP, no stem/conv3x3")
            forwards = 3 * 2  # 3 batches, weights and EMA
            if counts.delta[("val", 1)] != {"lap": forwards, "stem": 2 * forwards, "conv3x3": 12 * forwards}:
                raise AssertionError(f"train_path bf16 b{B} validation: launches {counts.delta[('val', 1)]} "
                                     f"over {forwards} forwards, want 1 LAP, 2 stem, 12 conv3x3 each")
            if fit_counts != {k: sum(d[k] for d in counts.delta.values()) for k in fit_counts}:
                raise AssertionError(f"train_path bf16 b{B}: launches {fit_counts} outside the epochs")
            for k, v in fit_counts.items():
                launches[k] = launches.get(k, 0) + v
            step_s = counts.wall[("train", 1)] / 3
            # host syncs in one more train step (after the count is read)
            batch = trainer.to_device(next(iter(batch_iterator(ds, B, shuffle=False))))
            step_syncs = _syncs_in(lambda: train_step(trainer.state, cfg, batch, trainer.step_generator(99)))
            row = dict(steps_per_s=1.0 / step_s, samples_per_s=B / step_s, ms_per_step=step_s * 1e3,
                       timed="second epoch, 3 steps, with batch loading and the copy",
                       first_epoch_s=counts.wall[("train", 0)], val_s=counts.wall[("val", 1)],
                       peak_mem_gb=peak_gb, cache_write_s=cache_s, train_losses_last=train_rows[-1],
                       val=val, host_syncs_in_one_train_step=len(step_syncs),
                       sync_sources=sorted(set(step_syncs))[:8], launches_fit=fit_counts,
                       launches_train={k: counts.delta[("train", 0)][k] + counts.delta[("train", 1)][k]
                                       for k in ("lap", "stem", "conv3x3")},
                       launches_val=counts.delta[("val", 1)])
            log(f"train_path bf16 b{B}", **row)
            del trainer, batch
            torch.cuda.empty_cache()
    return launches


def phase_train_path(dev) -> dict:
    """The training path: `Trainer.fit` in bf16 (the launch counts are set
    to 0 just before each fit and read just after it, summed over B=8 and
    B=64), then the float32 card-vs-CPU step."""
    counts = phase_train_bf16(dev)
    log("train_path launches", **counts)
    phase_train_f32(dev)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import diffusiondrive_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_device()
    build_logs = phase_build()
    summary = phase_kernels(dev)
    summary.update(phase_lap(dev, build_logs))
    counts = {"main_path": phase_main_path(dev), "agent_path": phase_agent_path(dev),
              "train_path": phase_train_path(dev)}

    bf = torch.bfloat16
    kernels = []
    for name, key, row, src, replaces, errs in (
        ("stem_fused", "stem", summary[("stem", "camera", bf)], "diffusiondrive_torch/csrc/stem_fused.cu",
         "diffusiondrive_tpu/ops/stem_fused.py:95",
         [summary[("stem", lbl, bf)]["max_abs_err"] for lbl in ("camera", "lidar")]),
        ("conv3x3_fused", "conv3x3", summary[("conv3x3", "image", "residual", bf)],
         "diffusiondrive_torch/csrc/conv3x3_fused.cu", "diffusiondrive_tpu/ops/conv_fused.py:55",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "conv3x3" and k[-1] == bf]),
        ("lidar_splat", "splat", summary[("lidar_splat", 16)], "diffusiondrive_torch/csrc/lidar_splat.cu",
         "diffusiondrive_tpu/ops/lidar_splat.py:47",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "lidar_splat"]),
        ("lap", "lap", summary[("lap", 64)], "diffusiondrive_torch/csrc/lap.cu",
         "diffusiondrive_tpu/ops/hungarian.py:138",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "lap"]),
    ):
        by_path = {path: c[key] for path, c in counts.items() if key in c}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": max(errs), "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "pass": True,
                        **({"library": row["library"]} if "library" in row else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
