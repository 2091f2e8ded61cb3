#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It drives
`diffusiondrive_torch` only (never JAX or the JAX package) and prints one
line per phase, then one JSON line per kernel summary, then the result:

1. ``device``  the card's name and power limit (nvidia-smi).
2. ``build``   builds every CUDA kernel from `diffusiondrive_torch/csrc/`
               with nvcc for sm_90a (one nvcc per source, in parallel) into
               `diffusiondrive_torch/_build/`; prints seconds and ptxas stats,
               and fails unless ptxas reports 0 spill bytes for each of the
               four instantiations (DP = 16, 32, 64, 128) of every
               tensor-core attention kernel (`MMA_KERNELS`: the forward and
               the backward's two launches), each of the four (residual,
               ReLU) of the tensor-core conv3x3 kernel (`CONV_MMA_KERNEL`)
               and each of the four (C = 1..4) of the tensor-core stem
               kernel (`STEM_MMA_KERNEL`), and for the LAP and splat
               kernels (`SINGLE_KERNELS`).
3. ``kernel``  each kernel at its main-path shapes (B=16, and the camera stem
               also at B=1; the conv kernels in bf16 and f32) against its
               plain PyTorch version (max abs error and the tolerance; the
               lidar splat must be exact and the same bits twice, on the
               agent path's clouds and on a uniform cloud, its rows naming
               `path` "segments" and the launch plan; stem and conv3x3 rows name their
               kernel in `path`, "mma" for bf16 on the tensor cores or
               "cuda_core" for float32, bf16 rows also hold 2 bf16 ulps of
               max |plain|, two calls give the same bits, and
               `library_conv_ms` is the bare `F.conv2d`), timed beside
               the plain version, a library yardstick (`library_ms`, never
               used by the port) and the card's bound for the same work
               (`bound_ms`). Every time in a kernel row comes from one timer,
               `time_rows`: the median of 3 repeats, each the device time of
               launches queued behind a spin kernel (`queued_ms`: not the
               host's launch rate), the three beside it as `*_runs`.
               ``kernel attention_fwd`` / ``attention_bwd`` (the fused
               attention at the fusion blocks' B=64, H=4, T=320 and each
               stage's D = 16, 32, 64, 128, bf16 and f32, without and with a
               p=0.1 keep mask; `path` names the kernel that ran, "mma"
               (bf16, tensor cores) or "cuda_core" (f32); library:
               `scaled_dot_product_attention` unmasked with its backend
               pinned, `SDPA_BACKEND`; one untimed pass over the first row
               first) and ``kernel conv3x3_train`` (its forward and input
               gradient at the B=64 layer-1 shapes in bf16, within 2 bf16
               ulps too, and one autograd backward against the plain
               version's; library: cuDNN `conv2d` and `conv2d_input`).
4. ``main_path`` the full-width planner forward (default TransfuserConfig,
               seeded random weights): (a) float32 at B=1 on the card against
               the same model on the CPU; (b) bf16 at B=1 and B=16, finite
               outputs and frames/s. The kernel launch counters are set to 0
               before this phase and must read 2 stem and 12 conv3x3 launches
               per forward, and no attention launch, after it. (c) ``fused``:
               one float32 forward with both kernel switches on
               (`fused_conv_mode="train"`, `fused_attention_mode="on"`),
               against the CPU forward of (a) within the same gate, counted on
               its own: exactly 2 stem, 12 conv3x3 and 8 attention launches.
5. ``agent_path`` the raw-sensor agent (`DiffusionDriveAgent(
               preprocess_on_device=True)`, full width): (a) float32 at B=1 on
               the card against the same agent on the CPU (stitched camera,
               BEV and every output); (b) bf16 `compute_trajectory` at B=1 and
               `forward` at B=16: finite outputs, frames/s with the inputs
               already on the card and with the host-to-device copy, the copy's
               ms on its own line, peak memory. The counters are set to 0
               before this phase and must read 1 splat, 2 stem and 12 conv3x3
               launches per agent forward (no attention launch) after it.
5b. ``pdm_score_path`` NAVSIM scoring through the port's runner
               (`evaluate/runner.py:run_pdm_score_evaluation`): 2 batches of
               32 scenes (the runner's default batch size) after one warm-up
               batch; the bf16 raw-sensor agent at full width and depth
               (seeded weights, default kernels; seeded
               `entry.example_agent_input` sensors held in memory), then
               both proposals of each scene (PDM-Closed's and the agent's)
               re-simulated and scored on the card; metric caches at the
               caching pipeline's padded shapes (96 tracks, 256 polygons of
               48 vertices: `pdm_road_cache`, a straight four-lane road with
               seeded agents), saved by `MetricCache.save` and read back by
               `MetricCacheLoader`. Fails unless every row is valid and the
               runner logged no error (a quarantined token or the per-token
               fallback), the counters (0 just before the counted run) read
               exactly 1 splat, 2 stem and 12 conv3x3 launches per batch,
               the CSV written by `write_score_csv` reads back with `csv`,
               the card's float32 scores of the first batch equal the CPU's
               on its first 8 scenes (discrete sub-scores and time indices
               equal, score and progress within 1e-4 x max(1, |CPU|)), both
               golden scenarios of `tests/test_golden_scores.py` hold on the
               card, and simulate and score make no host sync. Prints the
               runner's scenes/s (host clock, end to end with the agent),
               the simulate and score device ms of a 32-scene batch
               (`time_rows`, and the profiler's busy ms), their launches,
               host syncs per batch and peak memory, each beside the card.
6. ``kernel lap b8`` / ``b64`` the batched Hungarian kernel at n=30 (float32
               costs from a seed, half of each batch integer costs in [0, 4)
               for ties): its assignment equals the plain version's on the
               card exactly and its total cost scipy's within 1e-5 relative;
               kernel_ms, plain_ms, library_ms (scipy on the host, with the
               copy: no PyTorch call solves an assignment), bound_ms and
               ptxas registers/spills; the kernel makes no host sync
               (`torch.cuda.set_sync_debug_mode`); `path` "warp_redux",
               `critical_steps` (the longest chain of search steps and
               augment hops over the batch, counted by the plain version
               on the card outside the timed window) and `ns_per_step`.
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
               is their sum over both fits. ``fused``: the same fits on the
               same cache with both kernel switches on (dropout live): per
               train step exactly 8 attention forwards, 8 attention
               backwards and 24 conv3x3 launches (12 forwards, 12 input
               gradients), per validation forward 2 stem, 12 conv3x3, 8
               attention and 1 LAP.
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
               ``controls``: first, two plain float32 steps with 1e-6
               relative noise at the modules the switches replace must pass
               the same gradient gate (the comparison point is smooth).
               ``fused``: the float32 step with both switches on (8 + 8
               attention and 24 conv3x3 launches), under the same gates.
8. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Any failure raises and exits non-zero; without a CUDA device it exits 2
before printing any result.
"""

from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Tolerances are relative: the limit on max |got - want| is tol * max(1, max |want|).
# float32: sums in another order. bf16: f32 sums in another order tip a
# rounding to bf16 (every bf16 row also holds 2 bf16 ulps, `check_bf16_ulps`).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # kernel vs plain
MAIN_TOL = 1e-3            # card f32 forward vs CPU f32 forward
COMPARISON_SEEDS = (5, 10)  # `comparison_batch` seeds of the float32 step gates (at each, some float32 step
                            # takes another side of a ReLU than float64: PERF.md)
KINK_TOL = 1e-3             # float32 ReLU and max-pool inputs vs float64's, over max |float64|


def _fused_config():
    from diffusiondrive_torch.models.config import TransfuserConfig

    return TransfuserConfig(fused_conv_mode="train", fused_attention_mode="on")


def _launch_counters() -> dict:
    """The kernel wrappers a train step can reach, by short name; each counts
    its launches in `launches`."""
    from diffusiondrive_torch.ops.attention_fused import fused_attention, fused_attention_bwd
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
    from diffusiondrive_torch.ops.stem_fused import fused_stem

    return {"lap": batched_linear_sum_assignment, "stem": fused_stem, "conv3x3": fused_conv3x3,
            "attention_fwd": fused_attention, "attention_bwd": fused_attention_bwd}


# kernel launches per train step and per validation forward, default and switched
STEP_LAUNCHES = {False: {"lap": 1, "stem": 0, "conv3x3": 0, "attention_fwd": 0, "attention_bwd": 0},
                 True: {"lap": 1, "stem": 0, "conv3x3": 24, "attention_fwd": 8, "attention_bwd": 8}}
VAL_LAUNCHES = {False: {"lap": 1, "stem": 2, "conv3x3": 12, "attention_fwd": 0, "attention_bwd": 0},
                True: {"lap": 1, "stem": 2, "conv3x3": 12, "attention_fwd": 8, "attention_bwd": 0}}


_T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One phase line; `elapsed_s` is the script's wall time when it is printed."""
    fields["elapsed_s"] = round(time.perf_counter() - _T0, 2)
    print(phase + ": " + json.dumps(fields), flush=True)


SPIN_CYCLES = 20_000_000   # ~10 ms of `torch.cuda._sleep` at the H100's boost clock


def queued_ms(fn, iters: int, warmup: int):
    """(mean device time of `fn` over `iters` launches by CUDA events, whether
    the host fell behind). The launches are queued behind a ~10 ms spin
    kernel, so a call whose host side outlasts its device work (SDPA through
    autograd, a plain version of many small launches) is timed by its device
    work, and the clocks are up when the timed launches start. `host_behind`:
    the device reached the first timed launch before the host had queued the
    last one (a call that synchronises with the host always does)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_behind = start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_behind


def time_rows(fns: dict, iters: int = 10, warmup: int = 3) -> dict:
    """The one timer of every kernel row: each of `fns` (name -> callable)
    timed as the median of 3 repeats of `queued_ms`; the three repeats beside
    it as `<name>_runs`, and under `host_behind` the names whose host fell
    behind in any repeat."""
    out, behind = {}, []
    for name, fn in fns.items():
        runs, flags = zip(*(queued_ms(fn, iters, warmup) for _ in range(3)))
        out[name], out[name + "_runs"] = sorted(runs)[1], list(runs)
        if any(flags):
            behind.append(name)
    out["host_behind"] = behind
    return out


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype):
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nhwc_randn(shape, gen, device, dtype):
    """(B, H, W, C) normal draw -> NCHW view in channels_last memory."""
    return torch.randn(shape, generator=gen).to(device, dtype).permute(0, 3, 1, 2)


def check_bf16_ulps(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The bf16 rows' second limit, 2 bf16 ulps (2 * 2^-8) of max |want|:
    kernel and plain version round to bf16 at the same places (attention: p
    and the score gradient, then the result; stem and conv3x3: the result
    only), so a last-bit float32 difference before a rounding flips it by
    one ulp and the result's own rounding by one more (as the CPU tests
    against JAX). Returns the limit; raises past it."""
    err = (got.float() - want.float()).abs().max().item()
    limit = 2.0 * 2.0 ** -8 * want.float().abs().max().item()
    if not err <= limit:
        raise AssertionError(f"{name}: max abs err {err} > 2 bf16 ulps of max |plain| {limit}")
    return limit


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


# the tensor-core attention kernels of `csrc/attention_fused.cu`, each built for DP = 16, 32, 64, 128
MMA_KERNELS = ("attn_fwd_mma_kernel", "attn_bwd_dq_mma_kernel", "attn_bwd_dkdv_mma_kernel")
# the tensor-core conv3x3 kernel of `csrc/conv3x3_fused.cu`, built for (RES, RELU) in {0, 1}^2
CONV_MMA_KERNEL = "conv3x3_mma_kernel"
# the tensor-core stem kernel of `csrc/stem_fused.cu`, built for C = 1, 2, 3, 4
STEM_MMA_KERNEL = "stem_mma_kernel"
# the kernels of `csrc/lap.cu` and `csrc/lidar_splat.cu` (no templates), by source
SINGLE_KERNELS = {"lap": "lap_kernel", "lidar_splat": "splat_kernel"}


def ptxas_stats(text: str, kernel: str) -> dict:
    """{"<template arguments>": [registers, spill store bytes, spill load
    bytes]} for every instantiation of `kernel`, from an nvcc `-Xptxas -v`
    log; the key joins the integer template arguments ("128"; "1,0"), and is
    "" for a kernel that is no template."""
    out, key = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            args = re.search(re.escape(kernel) + r"I((?:L[a-z]+\d+E)+)E", m.group(1))
            if args:
                key = ",".join(re.findall(r"L[a-z]+(\d+)E", args.group(1)))
            else:  # a plain kernel's mangled name holds "<length><name>E"
                key = "" if f"{len(kernel)}{kernel}E" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and key is not None:
            out[key] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and key is not None and key in out:
            out[key][0] = int(m.group(1))
            key = None
    return out


def phase_build() -> dict:
    from diffusiondrive_torch.ops import _build

    t0 = time.time()
    built = sorted(_build.build_all())
    missing = [n for n in _build.kernel_names() if not _build._target(n).exists()]
    if missing:
        raise RuntimeError(f"kernel libraries not built: {missing}")
    logs = {n: _build.build_log(n) for n in _build.kernel_names()}  # this build's or the cached one's
    stats = [ln.strip() for name, text in logs.items()
             if name not in ("attention_fused", "conv3x3_fused", "stem_fused", *SINGLE_KERNELS)
             for ln in text.splitlines() if "registers" in ln or "spill" in ln]
    mma = {k: ptxas_stats(logs["attention_fused"], k) for k in MMA_KERNELS}
    conv = {CONV_MMA_KERNEL: ptxas_stats(logs["conv3x3_fused"], CONV_MMA_KERNEL)}
    stem = {STEM_MMA_KERNEL: ptxas_stats(logs["stem_fused"], STEM_MMA_KERNEL)}
    single = {k: ptxas_stats(logs[src], k).get("") for src, k in SINGLE_KERNELS.items()}
    log("build", seconds=round(time.time() - t0, 3), built=built,
        kernels=_build.kernel_names(), ptxas=stats[:24], attn_mma_regs_spills=mma,
        conv_mma_regs_spills=conv, stem_mma_regs_spills=stem, lap_splat_regs_spills=single)
    bad = {k: v for k, v in {**mma, **conv, **stem}.items()
           if len(v) != 4 or any(st or ld for _, st, ld in v.values())}
    if bad:
        raise AssertionError(f"tensor-core kernels: want 4 instantiations each with 0 spill bytes, got {bad}")
    bad = {k: v for k, v in single.items() if v is None or v[1] or v[2]}
    if bad:
        raise AssertionError(f"LAP and splat kernels: want 0 spill bytes each, got {bad}")
    return logs


def phase_kernels(dev) -> dict:
    from diffusiondrive_torch.ops.conv_fused import conv3x3_kernel, conv3x3_plain, fused_conv3x3, to_hwio
    from diffusiondrive_torch.ops.stem_fused import fused_stem, stem_kernel, stem_plain

    gen = torch.Generator().manual_seed(0)
    s = (torch.rand(64, generator=gen) + 0.5).to(dev)
    b = (torch.randn(64, generator=gen) * 0.1).to(dev)
    summary = {}

    for label, shape in STEM_ROWS:
        B, H, W, C = shape
        w_oihw = (torch.randn(64, C, 7, 7, generator=gen) / (49 * C) ** 0.5).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = nhwc_randn(shape, gen, dev, dtype)
            w = to_hwio(w_oihw, dtype)   # laid out once, as the model does
            got, again, want = fused_stem(x, w, s, b), fused_stem(x, w, s, b), stem_plain(x, w, s, b)
            torch.cuda.synchronize()
            tag = f"stem {label} {dtype}"
            err, limit = check_close(tag, got, want, TOL[dtype])
            ulps = check_bf16_ulps(tag, got, want) if dtype == torch.bfloat16 else None
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two calls gave different bits")
            wc = w_oihw.to(dtype)
            wf = (w_oihw * s[:, None, None, None]).to(dtype)
            bf = b.to(dtype)
            esize = x.element_size()
            flops = 2.0 * B * (H // 2) * (W // 2) * 64 * 49 * C
            nbytes = esize * (B * H * W * C + B * (H // 4) * (W // 4) * 64 + 49 * C * 64) + 2 * 64 * 4
            bms, by = bound_ms(flops, nbytes, dtype)
            row = dict(shape=list(shape), dtype=str(dtype), path=stem_kernel(dtype), max_abs_err=err,
                       limit=limit, ulp_limit=ulps,
                       **time_rows({"kernel_ms": lambda: fused_stem(x, w, s, b),
                                    "plain_ms": lambda: stem_plain(x, w, s, b),
                                    "library_ms": lambda: F.max_pool2d(
                                        torch.relu_(F.conv2d(x, wf, bf, stride=2, padding=3)), 3, 2, 1),
                                    "library_conv_ms": lambda: F.conv2d(x, wc, stride=2, padding=3)}),
                       bound_ms=bms, bound_by=by)
            log(f"kernel stem {label}", **row)
            summary[("stem", label, dtype)] = row

    for label, shape in CONV_EVAL:
        B, H, W, _ = shape
        w_oihw = (torch.randn(64, 64, 3, 3, generator=gen) / 24.0).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = nhwc_randn(shape, gen, dev, dtype)
            r = nhwc_randn(shape, gen, dev, dtype)
            w = to_hwio(w_oihw, dtype)
            wc = w_oihw.to(dtype)
            wf = (w_oihw * s[:, None, None, None]).to(dtype)
            bf = b.to(dtype)
            for res in (None, r):
                got = fused_conv3x3(x, w, s, b, res, relu=True)
                again = fused_conv3x3(x, w, s, b, res, relu=True)
                want = conv3x3_plain(x, w, s, b, res, relu=True)
                torch.cuda.synchronize()
                variant = "residual" if res is not None else "no_residual"
                tag = f"conv3x3 {label} {variant} {dtype}"
                err, limit = check_close(tag, got, want, TOL[dtype])
                ulps = check_bf16_ulps(tag, got, want) if dtype == torch.bfloat16 else None
                if not torch.equal(got, again):
                    raise AssertionError(f"{tag}: two calls gave different bits")
                esize = x.element_size()
                flops = 2.0 * B * H * W * 64 * 576
                nbytes = esize * (B * H * W * 64 * (2 + (res is not None)) + 576 * 64) + 2 * 64 * 4
                bms, by = bound_ms(flops, nbytes, dtype)
                if res is None:
                    lib = lambda: torch.relu_(F.conv2d(x, wf, bf, padding=1))  # noqa: E731
                else:
                    lib = lambda: torch.relu_(F.conv2d(x, wf, bf, padding=1).add_(r))  # noqa: E731
                row = dict(shape=list(shape), dtype=str(dtype), variant=variant, path=conv3x3_kernel(dtype),
                           max_abs_err=err, limit=limit, ulp_limit=ulps,
                           **time_rows({"kernel_ms": lambda: fused_conv3x3(x, w, s, b, res, relu=True),
                                        "plain_ms": lambda: conv3x3_plain(x, w, s, b, res, relu=True),
                                        "library_ms": lib,
                                        "library_conv_ms": lambda: F.conv2d(x, wc, padding=1)}),
                           bound_ms=bms, bound_by=by)
                log(f"kernel conv3x3 {label} {variant}", **row)
                summary[("conv3x3", label, variant, dtype)] = row

    summary.update(phase_lidar_splat(dev))
    return summary


SPLAT_N = 131072   # points per cloud at the agent path's `max_points`
SPLAT_BINS = 256   # the agent path's `lidar_resolution_width`


def splat_inputs(dev) -> dict:
    """The splat's inputs, (B=16, N) int32 bin indices on `dev` by cloud
    kind. "example": seeded `example_point_cloud`s (hot bins next to the
    ego, consecutive points in one bin, points beyond +-32 m, above
    `max_height_lidar` and below the split plane, points on the bin edges,
    and padding) binned as the agent path bins them; "uniform": every point
    in a uniformly drawn bin (no hot bin, no run of equal bins)."""
    from diffusiondrive_torch.entry import example_point_cloud
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.lidar_splat import _bin_indices
    from diffusiondrive_torch.ops.preprocessing import pad_point_cloud

    cfg = TransfuserConfig()
    bins = SPLAT_BINS
    rng = np.random.default_rng(3)
    clouds = [pad_point_cloud(example_point_cloud(rng, SPLAT_N - 2048 * b, cfg), SPLAT_N) for b in range(16)]
    points = torch.from_numpy(np.stack([p for p, _ in clouds])).to(dev)
    valid = torch.from_numpy(np.stack([v for _, v in clouds])).to(dev)
    keep = valid & (points[..., 2] < cfg.max_height_lidar) & (points[..., 2] > cfg.lidar_split_height)
    example = _bin_indices(points[..., :2], keep, cfg.lidar_min_x, cfg.lidar_max_x,
                           cfg.lidar_min_y, cfg.lidar_max_y, bins)
    uniform = tuple(torch.from_numpy(rng.integers(0, bins, size=(16, SPLAT_N), dtype=np.int32)).to(dev)
                    for _ in range(2))
    return {"example": example, "uniform": uniform}


def phase_lidar_splat(dev) -> dict:
    """The splat kernel at the agent path's batches (B=16, 1) against its
    plain version: exact, and the same bits in two runs; on the agent path's
    clouds (the `kernel lidar_splat b16` / `b1` rows, the `kernels` line's
    entry) and on a uniform cloud (`kernel lidar_splat uniform b16` / `b1`)."""
    from diffusiondrive_torch.ops.lidar_splat import histogram2d, histogram2d_plain, splat_plan

    bins = SPLAT_BINS
    summary = {}
    for kind, (ix, iy) in splat_inputs(dev).items():
        for B in (16, 1):
            bx, by = ix[:B].contiguous(), iy[:B].contiguous()
            got, again, want = histogram2d(bx, by, bins), histogram2d(bx, by, bins), histogram2d_plain(bx, by, bins)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if err != 0 or not torch.equal(got, again):
                raise AssertionError(f"lidar_splat {kind} B={B}: max abs err {err} (must be 0), "
                                     f"repeatable {torch.equal(got, again)}")
            if not torch.equal(want.cpu(), histogram2d_plain(bx.cpu(), by.cpu(), bins)):
                raise AssertionError(f"lidar_splat {kind} B={B}: plain version differs between card and CPU")
            # library yardstick: one scatter_add_ of ones into a (B*bins^2 + 1) buffer, skipped
            # points into the last (overflow) bucket, as `histogram2d_jax` does
            ok = bx >= 0
            batch = torch.arange(B, device=dev)[:, None] * bins * bins
            flat = torch.where(ok, batch + bx.long() * bins + by.long(), B * bins * bins).flatten()
            ones = torch.ones(flat.shape, device=dev)
            buf = torch.zeros(B * bins * bins + 1, device=dev)
            nbytes = 8.0 * B * SPLAT_N + 4.0 * B * bins * bins
            bms, by_what = bound_ms(0.0, nbytes, torch.float32)
            plan = splat_plan(B, SPLAT_N, bins, torch.cuda.get_device_properties(dev).multi_processor_count)
            row = dict(shape=[B, SPLAT_N], bins=bins, cloud=kind, path="segments", plan=plan._asdict(),
                       points_counted=int(ok.sum().item()), nonzero_bins=int((want > 0).sum().item()),
                       hottest_bin=int(want.max().item()), max_abs_err=err, same_bits_twice=True,
                       **time_rows({"kernel_ms": lambda: histogram2d(bx, by, bins),
                                    "plain_ms": lambda: histogram2d_plain(bx, by, bins),
                                    "library_ms": lambda: buf.scatter_add_(0, flat, ones)}),
                       bound_ms=bms, bound_by=by_what)
            label = f"b{B}" if kind == "example" else f"{kind} b{B}"
            log(f"kernel lidar_splat {label}", **row)
            summary[("lidar_splat", B) if kind == "example" else ("lidar_splat", kind, B)] = row
    return summary


ATTN_BHT = (64, 4, 320)        # batch, heads, tokens of the fusion blocks at the CLI's batch
ATTN_D = (16, 32, 64, 128)     # head widths of fusion stages 1-4 (C / 4 for C = 64..512)
# the stems at B=16, and the camera at B=1 (NAVSIM's per-scene call), NHWC
STEM_ROWS = (("camera", (16, 256, 1024, 3)), ("lidar", (16, 256, 256, 1)), ("camera b1", (1, 256, 1024, 3)))
CONV_EVAL = (("image", (16, 64, 256, 64)), ("lidar", (16, 64, 64, 64)))   # layer 1 at B=16, NHWC
CONV_TRAIN = (("image", (64, 64, 256, 64)), ("lidar", (64, 64, 64, 64)))  # layer 1 at B=64, NHWC
# the SDPA yardstick's backend, pinned: what SDPA picks on the H100 for the attention rows' shapes
SDPA_BACKEND = {torch.bfloat16: SDPBackend.CUDNN_ATTENTION, torch.float32: SDPBackend.EFFICIENT_ATTENTION}


def phase_attention(dev) -> dict:
    """The fused attention kernels (forward, backward) at the fusion blocks'
    shapes (B=64, H=4, T=320, every stage's D) in bf16 and f32, without and
    with a p=0.1 keep mask, against their plain versions on the same inputs
    (bf16 also within 2 bf16 ulps of max |plain|, `check_bf16_ulps`):
    q, k, v and dO as (B, H, T, D) views of (B, T, H, D) memory, as the
    model hands them over. library_ms: `F.scaled_dot_product_attention`
    unmasked (forward; forward and backward through autograd), never called
    by the port, its backend pinned (`SDPA_BACKEND`). Times: `time_rows`,
    after one untimed pass over the first row.
    Bound: the forward's 4·B·H·T²·D flops and its q, k, v, o (and mask)
    bytes; the backward's 10·B·H·T²·D flops (the five products of a
    recomputing backward) and its q, k, v, dO, dq, dk, dv (and mask)."""
    from diffusiondrive_torch.ops.attention_fused import (
        attention_bwd_plain, attention_fwd_plain, backward_kernel, dropout_keep_mask, forward_kernel,
        fused_attention, fused_attention_bwd)

    B, H, T = ATTN_BHT
    gen, mask_gen = torch.Generator().manual_seed(4), torch.Generator(device=dev)
    summary, warm = {}, False
    for D in ATTN_D:
        base = [torch.randn(B, T, H, D, generator=gen) for _ in range(4)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (t.to(dev, dtype).transpose(1, 2) for t in base)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            esize = q.element_size()
            backend = SDPA_BACKEND[dtype]

            def lib_fwd():
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(q, k, v)

            def lib_bwd():  # the forward's backend fixes the backward's
                with sdpa_kernel(backend):
                    return torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, do)

            for pdrop in (0.0, 0.1):
                mask = dropout_keep_mask(mask_gen.manual_seed(D), (B, H, T, T), pdrop, dev) if pdrop else None
                variant = "masked" if pdrop else "no_mask"
                mbytes = B * H * T * T if pdrop else 0
                tag = f"D={D} {variant} {dtype}"
                fwd_fns = {"kernel_ms": lambda: fused_attention(q, k, v, mask, pdrop),
                           "plain_ms": lambda: attention_fwd_plain(q, k, v, mask, pdrop), "library_ms": lib_fwd}
                bwd_fns = {"kernel_ms": lambda: fused_attention_bwd(q, k, v, mask, do, pdrop),
                           "plain_ms": lambda: attention_bwd_plain(q, k, v, mask, do, pdrop),
                           "library_ms": lib_bwd}
                if not warm:  # one untimed pass over the first row: clocks, caches and handles settle
                    for fn in (*fwd_fns.values(), *bwd_fns.values()):
                        queued_ms(fn, 10, 3)
                    warm = True
                got, want = fused_attention(q, k, v, mask, pdrop), attention_fwd_plain(q, k, v, mask, pdrop)
                torch.cuda.synchronize()
                err, limit = check_close(f"attention_fwd {tag}", got, want, TOL[dtype])
                ulps = check_bf16_ulps(f"attention_fwd {tag}", got, want) if dtype == torch.bfloat16 else None
                bms, by = bound_ms(4.0 * B * H * T * T * D, esize * 4.0 * B * H * T * D + mbytes, dtype)
                row = dict(shape=[B, H, T, D], dtype=str(dtype), variant=variant,
                           path=forward_kernel(dtype, D), max_abs_err=err, limit=limit, ulp_limit=ulps,
                           **time_rows(fwd_fns), library_backend=backend.name.lower(), bound_ms=bms, bound_by=by)
                log(f"kernel attention_fwd d{D} {variant}", **row)
                summary[("attention_fwd", D, variant, dtype)] = row

                got = fused_attention_bwd(q, k, v, mask, do, pdrop)
                again = fused_attention_bwd(q, k, v, mask, do, pdrop)
                want = attention_bwd_plain(q, k, v, mask, do, pdrop)
                torch.cuda.synchronize()
                errs = {name: check_close(f"attention_bwd {name} {tag}", g, w, TOL[dtype])
                        for name, g, w in zip(("dq", "dk", "dv"), got, want)}
                ulps = {name: check_bf16_ulps(f"attention_bwd {name} {tag}", g, w)
                        for name, g, w in zip(("dq", "dk", "dv"), got, want)} if dtype == torch.bfloat16 else None
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    raise AssertionError(f"attention_bwd {tag}: two calls gave different bits")
                del got, again, want
                bms, by = bound_ms(10.0 * B * H * T * T * D, esize * 7.0 * B * H * T * D + mbytes, dtype)
                row = dict(shape=[B, H, T, D], dtype=str(dtype), variant=variant,
                           path=backward_kernel(dtype, D), max_abs_err=max(e for e, _ in errs.values()),
                           errors={n: e for n, (e, _) in errs.items()}, limits={n: l for n, (_, l) in errs.items()},
                           ulp_limits=ulps, **time_rows(bwd_fns), library_backend=backend.name.lower(),
                           bound_ms=bms, bound_by=by)
                log(f"kernel attention_bwd d{D} {variant}", **row)
                summary[("attention_bwd", D, variant, dtype)] = row
    return summary


def phase_conv3x3_train(dev) -> dict:
    """`conv3x3_train` at the layer-1 shapes of a B=64 train step in bf16:
    its forward and its input gradient (the conv3x3 kernel with the flipped,
    transposed weight) against the plain versions; then one backward through
    autograd against the plain version's (dx and the library's dw).
    library_ms: cuDNN `F.conv2d` and `torch.nn.grad.conv2d_input`."""
    from diffusiondrive_torch.ops.conv_fused import (
        conv3x3_kernel, conv3x3_plain, conv3x3_train, conv3x3_train_plain, fused_conv3x3, to_hwio)

    gen = torch.Generator().manual_seed(5)
    one, zero = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    dtype = torch.bfloat16
    summary = {}
    for label, shape in CONV_TRAIN:
        B, H, W, _ = shape
        x, g = nhwc_randn(shape, gen, dev, dtype), nhwc_randn(shape, gen, dev, dtype)
        w_oihw = (torch.randn(64, 64, 3, 3, generator=gen) / 24.0).to(dev, dtype)
        w = to_hwio(w_oihw, dtype)
        w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
        res = {}
        for name, fn in (("kernel", conv3x3_train), ("plain", conv3x3_train_plain)):
            xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
            fn(xl, wl).backward(g)
            res[name] = (xl.grad, wl.grad)
        torch.cuda.synchronize()
        auto_err = {n: check_close(f"conv3x3_train {label} autograd {n}", a, b, TOL[dtype])[0]
                    for n, a, b in zip(("dx", "dw"), res["kernel"], res["plain"])}
        flops = 2.0 * B * H * W * 64 * 576
        nbytes = x.element_size() * (2.0 * B * H * W * 64 + 576 * 64)
        bms, by = bound_ms(flops, nbytes, dtype)
        for part, kern, plain, lib in (
            ("fwd", lambda: conv3x3_train(x, w), lambda: conv3x3_train_plain(x, w),
             lambda: F.conv2d(x, w_oihw, padding=1)),
            ("dx", lambda: fused_conv3x3(g, w_flip, one, zero), lambda: conv3x3_plain(g, w_flip, one, zero),
             lambda: torch.nn.grad.conv2d_input(x.shape, w_oihw, g, padding=1)),
        ):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err, limit = check_close(f"conv3x3_train {label} {part}", got, want, TOL[dtype])
            ulps = check_bf16_ulps(f"conv3x3_train {label} {part}", got, want)
            row = dict(shape=list(shape), dtype=str(dtype), part=part, path=conv3x3_kernel(dtype),
                       max_abs_err=err, limit=limit, ulp_limit=ulps, autograd_max_abs_err=auto_err,
                       **time_rows({"kernel_ms": kern, "plain_ms": plain, "library_ms": lib}),
                       bound_ms=bms, bound_by=by)
            log(f"kernel conv3x3_train {label} {part}", **row)
            summary[("conv3x3_train", label, part)] = row
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
    """The planner under the default config (counts zeroed before, read
    after), then one float32 forward with both kernel switches on
    (`main_path_fused`, counted on its own). Returns the counts by path."""
    from diffusiondrive_torch.entry import build_model, example_inputs
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.attention_fused import fused_attention
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

    fused_stem.launches = fused_conv3x3.launches = fused_attention.launches = 0
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
    counts = {"stem": fused_stem.launches, "conv3x3": fused_conv3x3.launches,
              "attention_fwd": fused_attention.launches}
    if counts != {"stem": 2 * forwards, "conv3x3": 12 * forwards, "attention_fwd": 0}:
        raise AssertionError(f"launch counts {counts} over {forwards} forwards, want 2 stem, 12 conv3x3 "
                             f"and no attention each")
    log("main_path launches", forwards=forwards, **counts)
    del model

    # (c) float32, B=1, both switches on: the fused attention in all 8 fusion blocks
    model_fused = build_model(_fused_config(), torch.float32, seed=0)
    model_fused.load_state_dict(model_cpu.state_dict())
    model_fused = model_fused.to(dev)
    fused_stem.launches = fused_conv3x3.launches = fused_attention.launches = 0
    with torch.no_grad():
        out_fused = model_fused(**inputs_gpu, diffusion_noise=noise.to(dev))
    torch.cuda.synchronize()
    fused_counts = {"stem": fused_stem.launches, "conv3x3": fused_conv3x3.launches,
                    "attention_fwd": fused_attention.launches}
    if fused_counts != {"stem": 2, "conv3x3": 12, "attention_fwd": 8}:
        raise AssertionError(f"main_path fused: launches {fused_counts}, want 2 stem, 12 conv3x3, 8 attention")
    _outputs_ok(out_fused, 1)
    errs = {k: check_close(f"main_path f32 fused {k}", out_fused[k].cpu(), out_cpu[k], MAIN_TOL)[0]
            for k in out_cpu}
    if int(out_fused["poses_cls"].argmax(-1).item()) != int(cls.argmax().item()):
        raise AssertionError("main_path fused: argmax mode differs from the CPU's")
    log("main_path f32 b1 fused card-vs-cpu", max_abs_err=errs, tol_rel=MAIN_TOL, argmax_equal=True,
        launches=fused_counts)
    return {"main_path": counts, "main_path_fused": fused_counts}


def phase_agent_path(dev) -> dict:
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.agents.diffusiondrive.features import RawSensorFeatureBuilder
    from diffusiondrive_torch.entry import agent_entry, example_agent_input
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.attention_fused import fused_attention
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.ops.stem_fused import fused_stem

    cfg = TransfuserConfig()
    builder = RawSensorFeatureBuilder(cfg)
    fused_stem.launches = fused_conv3x3.launches = histogram2d.launches = fused_attention.launches = 0
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
              "conv3x3": fused_conv3x3.launches, "attention_fwd": fused_attention.launches}
    if counts != {"splat": forwards, "stem": 2 * forwards, "conv3x3": 12 * forwards, "attention_fwd": 0}:
        raise AssertionError(f"launch counts {counts} over {forwards} agent forwards, "
                             f"want 1 splat, 2 stem, 12 conv3x3 and no attention each")
    log("agent_path launches", forwards=forwards, **counts)
    return counts


# --------------------------------------------------------------------------- #
# PDM scoring: scenes, caches, golden scenarios (also used by the card tests)
# --------------------------------------------------------------------------- #

PDM_SCENES = 32      # scenes a batch: the runner's default batch_size
PDM_BATCHES = 2
PDM_OBJECTS = 96     # track slots of the metric-caching pipeline (`max_objects`)
PDM_POLYGONS = 256   # drivable polygons (`max_polygons`), each of
PDM_VERTICES = 48    # `ring_pad` vertices
PDM_LOCAL_MAPS = 26  # one occupancy map per 2 of the 50 samples (40 poses + TTC lookahead), + 1
PDM_CPU_SCENES = 8   # scenes of the batch the CPU scores again (the card's rows of a 32-scene batch)
PDM_TOL = 1e-4       # card vs CPU: score, progress_raw, progress_normalized (x max(1, |CPU|))
PDM_FLOATS = ("score", "progress_raw", "progress_normalized")
LANE_W = 3.5


def _strip(x0, x1, y0, y1, n=PDM_VERTICES // 2):
    """A rectangle as a ring of 2n vertices: n along y0 (x0 -> x1), n back along y1."""
    xs = np.linspace(x0, x1, n)
    return np.concatenate([np.stack([xs, np.full(n, y0)], -1), np.stack([xs[::-1], np.full(n, y1)], -1)])


def pdm_road_cache(token: str, seed: int):
    """A metric cache at the metric-caching pipeline's padded shapes: a
    straight four-lane road (two lanes each way, 25 m segments from -25 to
    175 m ahead: lanes, roadblocks, an intersection with its lane
    connectors, a car park; 41 polygons, the rest of the 256 padding) and
    24-64 seeded agents in the 96 track slots (vehicles in the lanes, some
    stopped and some oncoming; pedestrians and static objects at the kerb),
    forecast at constant velocity; the ego in the right lane of its
    direction at 4-12 m/s; PDM-Closed's trajectory straight on at that speed;
    the route lane's centerline every metre."""
    from diffusiondrive_torch.common.dataclasses import TrajectorySampling
    from diffusiondrive_torch.common.enums import MapLayer, StateIndex
    from diffusiondrive_torch.evaluate.metric_cache import MetricCache
    from diffusiondrive_torch.evaluate.observation import (
        DrivableAreaArrays, TrackArrays, constant_velocity_forecast, pad_rings)

    rng = np.random.default_rng(seed)
    origin = np.array([1000.0 + 37.0 * seed, 500.0 - 11.0 * seed])
    rings, layers, route = [], [], []

    def add(ring, layer, on_route=False):
        rings.append(ring + origin)
        layers.append(layer)
        route.append(on_route)

    for seg in range(8):
        x0, x1 = -25.0 + 25.0 * seg, 25.0 * seg
        add(_strip(x0, x1, -2 * LANE_W, 2 * LANE_W), MapLayer.INTERSECTION if seg == 5 else MapLayer.ROADBLOCK)
        for lane in range(4):
            y0 = (lane - 2) * LANE_W
            layer = MapLayer.LANE_CONNECTOR if seg == 5 else MapLayer.LANE
            add(_strip(x0, x1, y0, y0 + LANE_W), layer, on_route=(lane == 2))
    add(_strip(30.0, 70.0, 2 * LANE_W, 2 * LANE_W + 25.0), MapLayer.CARPARK_AREA)
    polygons = np.full((PDM_POLYGONS, PDM_VERTICES, 2), 1e6, np.float32)
    polygons[:len(rings)] = pad_rings(rings, PDM_VERTICES)
    valid = np.arange(PDM_POLYGONS) < len(rings)
    layer_arr = np.zeros(PDM_POLYGONS, np.int32)
    layer_arr[:len(rings)] = layers
    route_arr = np.zeros(PDM_POLYGONS, bool)
    route_arr[:len(rings)] = route
    drivable = DrivableAreaArrays(polygons=polygons, valid=valid, layers=layer_arr, on_route=route_arr)

    O, n = PDM_OBJECTS, int(rng.integers(24, 65))
    boxes = np.full((O, 5), 1e6)
    boxes[:, 2] = 0.0
    vel = np.zeros((O, 2))
    is_agent = np.zeros(O, bool)
    for o in range(n):
        kind = rng.choice(3, p=[0.7, 0.2, 0.1])
        if kind == 0:   # vehicle in a lane, off the ego's start
            lane = int(rng.integers(4))
            x = rng.uniform(-20.0, 160.0)
            if lane == 2 and -10.0 < x < 12.0:
                x += 25.0
            heading = 0.0 if lane >= 2 else np.pi
            speed = 0.0 if rng.uniform() < 0.2 else rng.uniform(2.0, 14.0)
            boxes[o] = (x, (lane - 2 + 0.5) * LANE_W + rng.normal(0, 0.2), heading + rng.normal(0, 0.02),
                        rng.uniform(4.3, 5.2), rng.uniform(1.8, 2.1))
            is_agent[o] = True
        else:           # pedestrian (walking) or static object at the kerb
            side = rng.choice([-1.0, 1.0])
            heading = rng.choice([0.0, np.pi])
            speed = rng.uniform(0.0, 1.5) if kind == 1 else 0.0
            boxes[o] = (rng.uniform(-20.0, 160.0), side * (2 * LANE_W + rng.uniform(0.3, 1.5)), heading,
                        0.6 if kind == 1 else 1.0, 0.6 if kind == 1 else 1.0)
            is_agent[o] = kind == 1
        vel[o] = speed * np.cos(boxes[o, 2]), speed * np.sin(boxes[o, 2])
    boxes[:n, :2] += origin
    obj_valid = np.arange(O) < n
    sampling = TrajectorySampling(num_poses=40, interval_length=0.1)
    poses, g2l = constant_velocity_forecast(boxes, vel, obj_valid, obj_valid, sampling, observation_samples=50)
    speeds = np.hypot(vel[:, 0], vel[:, 1]).astype(np.float32)
    tracks = TrackArrays(poses=poses, extents=np.where(obj_valid[:, None], boxes[:, 3:5], 1.0).astype(np.float32),
                         valid=obj_valid, headings=np.where(obj_valid, boxes[:, 2], 0.0).astype(np.float32),
                         is_agent=is_agent, is_red_light=np.zeros(O, bool), is_stopped=speeds <= 5e-2,
                         previously_collided=np.zeros(O, bool), global_to_local=g2l, speeds=speeds)

    v0 = rng.uniform(4.0, 12.0)
    times = np.arange(41) * 0.1
    pdm_poses = np.stack([origin[0] + v0 * times, np.full(41, origin[1] + 0.5 * LANE_W), np.zeros(41)], -1)
    initial = np.zeros(StateIndex.size())
    initial[StateIndex.STATE_SE2] = pdm_poses[0]
    initial[StateIndex.VELOCITY_X] = v0
    xs = np.arange(-25.0, 176.0)
    centerline = (np.stack([xs, np.full(len(xs), 0.5 * LANE_W)], -1) + origin).astype(np.float32)
    return MetricCache(token=token, log_name="chip_smoke_road", pdm_poses=pdm_poses, pdm_times=times,
                       initial_state=initial, tracks=tracks, drivable=drivable, centerline=centerline,
                       route_lane_ids=[f"lane_{seg}_2" for seg in range(8)])


def golden_scenarios():
    """The two scenarios of `tests/test_golden_scores.py` as a batch of two
    scenes in `score_proposals`' argument order (numpy): (a) a clean 10 m/s
    drive tailgating a 9 m/s lead car 12 m ahead, both proposals; (b) 10 and
    2 m/s towards a parked car 20 m ahead. A straight 16 m corridor (a
    roadblock and an on-route lane), 4 track slots, 26 local maps."""
    from diffusiondrive_torch.common.enums import MapLayer, StateIndex

    def straight(v):
        st = np.zeros((41, StateIndex.size()), np.float32)
        st[:, StateIndex.X] = v * 0.1 * np.arange(41)
        st[:, StateIndex.VELOCITY_X] = v
        return st

    def scene(box, velocity, speeds):
        poses = np.full((PDM_LOCAL_MAPS, 4, 3), 1e6, np.float32)
        poses[..., 2] = 0.0
        for li in range(PDM_LOCAL_MAPS):
            poses[li, 0] = (box[0] + velocity[0] * li * 0.2, box[1] + velocity[1] * li * 0.2, box[2])
        extents = np.ones((4, 2), np.float32)
        extents[0] = box[3:]
        valid = np.arange(4) < 1
        rect = np.array([[-20, -8], [220, -8], [220, 8], [-20, 8]], np.float32)
        polys = np.full((4, 8, 2), 1e6, np.float32)
        polys[:2, :4], polys[:2, 4:] = rect, rect[3]
        x = np.linspace(-20, 220, 121)
        return (np.stack([straight(v) for v in speeds]), poses, extents, valid, valid.copy(),
                np.zeros(4, bool), ~valid | (np.hypot(*velocity) <= 5e-2), np.zeros(4, bool),
                np.arange(52, dtype=np.int32) // 2, polys, np.arange(4) < 2,
                np.array([MapLayer.ROADBLOCK, MapLayer.LANE, 0, 0], np.int32), np.array([False, True, False, False]),
                np.stack([x, np.zeros_like(x)], -1).astype(np.float32))

    scenes = [scene((12.0, 0.0, 0.0, 4.5, 2.0), (9.0, 0.0), (10.0, 10.0)),
              scene((20.0, 0.0, 0.0, 4.5, 2.0), (0.0, 0.0), (10.0, 2.0))]
    return [np.stack(a) for a in zip(*scenes)]


def check_golden(out) -> dict:
    """`tests/test_golden_scores.py`'s values on a `ScorerOutput` of
    `golden_scenarios()` (numpy); raises on a miss."""
    want = {"score": [[7 / 12, 7 / 12], [0.0, 1.0]], "ttc_time_idcs": [[40.0, 40.0], [5.0, np.inf]],
            "collision_time_idcs": [[np.inf, np.inf], [14.0, np.inf]], "ttc": [[0.0, 0.0], [0.0, 1.0]],
            "no_at_fault_collisions": [[1.0, 1.0], [0.0, 1.0]], "progress_raw": [[40.0, 40.0], [40.0, 8.0]]}
    tol = {"score": 1e-5, "progress_raw": 0.05}
    for k, v in want.items():
        got = np.asarray(getattr(out, k), np.float64)
        if not np.allclose(got, v, atol=tol.get(k, 0.0), rtol=0.0):
            raise AssertionError(f"golden scenarios: {k} {got.tolist()} != {v}")
    return {k: [[v if np.isfinite(v) else "inf" for v in row] for row in np.asarray(getattr(out, k)).tolist()]
            for k in ("score", "ttc_time_idcs", "collision_time_idcs")}


def pdm_outputs_match(name: str, got, want) -> dict:
    """Card vs CPU `ScorerOutput`s (numpy): every discrete sub-score equal,
    `PDM_FLOATS` within PDM_TOL x max(1, max |CPU|); returns the float errors."""
    errs = {}
    for k in got._fields:
        g, w = np.asarray(getattr(got, k), np.float64), np.asarray(getattr(want, k), np.float64)
        if k in PDM_FLOATS:
            errs[k] = float(np.abs(g - w).max())
            limit = PDM_TOL * max(1.0, float(np.abs(w).max()))
            if not errs[k] <= limit:
                raise AssertionError(f"{name} {k}: max abs err {errs[k]} > {limit}")
        elif not np.array_equal(g, w):
            bad = np.argwhere(g != w)[:4].tolist()
            raise AssertionError(f"{name} {k}: differs at {bad}")
    return errs


def _device_kernels(fn, top: int = 4):
    """(kernels `fn` runs on the card, their busy ms: the union of their
    intervals, the `top` kernel names by summed ms), by the profiler's raw
    device events (copies and memsets left out; read without building the
    profiler's event tree, which takes seconds for thousands of launches);
    a trace with no device event is taken again, at most three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and "memcpy" not in e.name().lower() and "memset" not in e.name().lower()]
        if events:
            spans = sorted((e.start_ns(), e.end_ns()) for e in events)
            busy, end = 0, spans[0][0]
            for s, e in spans:
                busy += max(0, e - max(s, end))
                end = max(end, e)
            by_name = {}
            for e in events:
                by_name[e.name()[:60]] = by_name.get(e.name()[:60], 0) + e.duration_ns() / 1e6
            return len(events), busy / 1e6, dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    raise AssertionError("the profiler saw no kernel on the card")


def phase_pdm_score_path(dev, card: str) -> dict:
    """NAVSIM scoring through the port's runner: `PDM_BATCHES` batches of
    `PDM_SCENES` raw-sensor scenes, the bf16 agent at full width and depth
    (seeded weights, default kernels), then simulation and scoring on the
    card; metric caches saved by `MetricCache.save` and read back by
    `MetricCacheLoader`. Returns the agent kernels' launch counts of the
    counted run (counts set to 0 just before it)."""
    import csv
    import logging

    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.common.dataclasses import Trajectory, TrajectorySampling
    from diffusiondrive_torch.common.dataloader import MetricCacheLoader
    from diffusiondrive_torch.entry import example_agent_input
    from diffusiondrive_torch.evaluate.pdm_score import scenes_to_device, score_scenes, simulate_and_score, stack_scenes
    from diffusiondrive_torch.evaluate.runner import SUB_SCORE_COLUMNS, run_pdm_score_evaluation, write_score_csv
    from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig, ScorerOutput, score_proposals
    from diffusiondrive_torch.evaluate.simulator import PDMSimulator
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.attention_fused import fused_attention
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.ops.stem_fused import fused_stem

    class RecordingAgent(DiffusionDriveAgent):
        """Keeps each batched forward's trajectories (for the card-vs-CPU check)."""

        def forward(self, features):
            out = super().forward(features)
            self.trajectories.append(out["trajectory"])
            return out

    class Loader:
        """Tokens and seeded raw-sensor agent inputs, in memory."""

        def __init__(self, inputs, tokens):
            self.inputs, self.tokens = inputs, list(tokens)

        def get_agent_input_from_token(self, token):
            return self.inputs[token]

    class Errors(logging.Handler):
        """Every ERROR the runner logs: a quarantined token or the per-token fallback."""

        def __init__(self):
            super().__init__(logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())

    cfg = TransfuserConfig()
    n = PDM_SCENES * PDM_BATCHES
    tokens = [f"scene_{i:03d}" for i in range(n)]
    simulator = PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    errors = Errors()
    logging.getLogger("diffusiondrive_torch.evaluate.runner").addHandler(errors)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pdm_") as tmp:
        t0 = time.perf_counter()
        for i, tok in enumerate(tokens):
            pdm_road_cache(tok, seed=i).save(Path(tmp) / "cache" / "chip_smoke_road" / tok / "metric_cache.npz")
        cache_loader = MetricCacheLoader(Path(tmp) / "cache")
        if sorted(cache_loader.tokens) != tokens:
            raise AssertionError(f"MetricCacheLoader found {len(cache_loader.tokens)} caches, want {n}")
        inputs = {tok: example_agent_input(cfg, seed=i) for i, tok in enumerate(tokens)}
        setup_s = time.perf_counter() - t0

        agent = RecordingAgent(cfg, dtype=torch.bfloat16, seed=0, preprocess_on_device=True, device=dev)
        agent.trajectories = []
        # warm-up: one batch
        run_pdm_score_evaluation(agent, Loader(inputs, tokens[:PDM_SCENES]), cache_loader, simulator,
                                 batch_size=PDM_SCENES, device=dev)
        agent.trajectories = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_stem.launches = fused_conv3x3.launches = histogram2d.launches = fused_attention.launches = 0
        t0 = time.perf_counter()
        rows = run_pdm_score_evaluation(agent, Loader(inputs, tokens), cache_loader, simulator,
                                        batch_size=PDM_SCENES, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"splat": histogram2d.launches, "stem": fused_stem.launches,
                  "conv3x3": fused_conv3x3.launches, "attention_fwd": fused_attention.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        logging.getLogger("diffusiondrive_torch.evaluate.runner").removeHandler(errors)
        if errors.records:
            raise AssertionError(f"pdm_score_path: the runner logged errors (quarantine or fallback): "
                                 f"{errors.records[:3]}")
        want = {"splat": PDM_BATCHES, "stem": 2 * PDM_BATCHES, "conv3x3": 12 * PDM_BATCHES, "attention_fwd": 0}
        if counts != want:
            raise AssertionError(f"pdm_score_path: launches {counts} over {PDM_BATCHES} batches, want {want}")
        if [r["token"] for r in rows] != tokens or not all(r["valid"] for r in rows):
            raise AssertionError(f"pdm_score_path: {sum(r['valid'] for r in rows)} valid rows of {len(rows)}")
        scores = np.array([[r[c] for c in SUB_SCORE_COLUMNS] for r in rows])
        if not np.isfinite(scores).all() or scores.min() < 0.0 or scores.max() > 1.0:
            raise AssertionError("pdm_score_path: sub-scores outside [0, 1]")
        with open(write_score_csv(rows, Path(tmp) / "csv"), newline="") as fp:
            table = list(csv.reader(fp))
        if (table[0] != ["", "token", "valid", *SUB_SCORE_COLUMNS] or [r[1] for r in table[1:]] != tokens + ["average"]
                or abs(float(table[-1][-1]) - scores[:, -1].mean()) > 1e-6):
            raise AssertionError(f"pdm_score_path: CSV header {table[0]}, {len(table)} lines")
        log("pdm_score_path runner bf16", card=card, scenes=n, batches=PDM_BATCHES, batch_size=PDM_SCENES,
            scenes_per_s=n / wall_s, wall_s=wall_s, peak_mem_gb=peak_gb, setup_s=setup_s,
            valid_rows=len(rows), fallback_taken=False, mean_score=float(scores[:, -1].mean()),
            mean_sub_scores=dict(zip(SUB_SCORE_COLUMNS, scores.mean(0).tolist())), launches=counts,
            inputs="seeded raw sensors in memory (no disk IO), caches read from .npz")

        # the first batch's caches and the agent's trajectories on the card
        # (float32), its first PDM_CPU_SCENES scenes again on the CPU
        caches = [cache_loader.get_from_token(tok) for tok in tokens[:PDM_SCENES]]
        trajs = [Trajectory(p) for p in agent.trajectories[0]]
        t0 = time.perf_counter()
        on_card = score_scenes(caches, trajs, simulator, device=dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = score_scenes(caches[:PDM_CPU_SCENES], trajs[:PDM_CPU_SCENES], simulator, device="cpu")
        cpu_s = time.perf_counter() - t0
        errs = pdm_outputs_match("pdm_score_path card-vs-cpu",
                                 ScorerOutput(*[v[:PDM_CPU_SCENES] for v in on_card]), on_cpu)
        golden = check_golden(ScorerOutput(*[v.cpu().numpy() for v in score_proposals(
            *[torch.from_numpy(a).to(dev) for a in golden_scenarios()], simulator.proposal_sampling)]))
        log("pdm_score_path f32 card-vs-cpu", card=card, scenes_on_card=PDM_SCENES, scenes_on_cpu=PDM_CPU_SCENES,
            max_abs_err=errs, tol_rel=PDM_TOL,
            discrete_equal=True, golden=golden, card_call_s=card_s, cpu_call_s=cpu_s,
            pred_score_mean=float(on_card.score[:, 1].mean()), pdm_score_mean=float(on_card.score[:, 0].mean()))

    # one batch of 32 scenes, split as the runner runs it: the features (the
    # IO threads' work), their stacking, the agent's forward with the copies,
    # the scenes' stacking and copy, then simulate and score on the device
    # (`time_rows`), launches and syncs
    builder = agent.get_feature_builders()[0]
    t0 = time.perf_counter()
    feats = [builder.compute_features(inputs[tok]) for tok in tokens[:PDM_SCENES]]
    features_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    stacked = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    stack_features_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.forward(stacked)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    del feats, stacked, inputs
    t0 = time.perf_counter()
    host = stack_scenes(caches, trajs, simulator.proposal_sampling)
    stack_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proposals, ctx = scenes_to_device(*host, dev)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    initial, rest = ctx[0], ctx[1:]
    with torch.no_grad():
        simulated = simulator.simulate_proposals(proposals, initial[:, None])
        simulate = lambda: simulator.simulate_proposals(proposals, initial[:, None])  # noqa: E731
        score = lambda: score_proposals(simulated, *rest, simulator.proposal_sampling, PDMScorerConfig())  # noqa: E731
        times = time_rows({"simulate": simulate, "score": score}, iters=3, warmup=1)
        host_ms = {}
        for name, fn in (("simulate", simulate), ("score", score)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms[name] = (time.perf_counter() - t0) * 1e3
        (sim_launches, sim_busy, sim_top), (score_launches, score_busy, score_top) = (
            _device_kernels(simulate), _device_kernels(score))
        syncs = _syncs_in(lambda: simulate_and_score(simulator, PDMScorerConfig(), proposals, *ctx))
        if syncs:
            raise AssertionError(f"simulate and score synchronise with the host: {syncs[:4]}")
        torch.cuda.reset_peak_memory_stats()
        score()
        torch.cuda.synchronize()
        score_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch_syncs = _syncs_in(lambda: score_scenes(caches, trajs, simulator, device=dev))
    log("pdm_score_path batch", card=card, scenes=PDM_SCENES, proposals=2 * PDM_SCENES,
        simulate_device_ms=times["simulate"], score_device_ms=times["score"],
        simulate_runs=times["simulate_runs"], score_runs=times["score_runs"], host_behind=times["host_behind"],
        simulate_busy_ms=sim_busy, score_busy_ms=score_busy, simulate_top_kernels_ms=sim_top,
        score_top_kernels_ms=score_top,
        simulate_host_ms=host_ms["simulate"], score_host_ms=host_ms["score"], stack_host_ms=stack_ms,
        h2d_ms=h2d_ms, features_host_ms=features_ms, stack_features_host_ms=stack_features_ms,
        agent_forward_host_ms=forward_ms, runner_ms_per_batch=wall_s / PDM_BATCHES * 1e3,
        launches_per_batch={"simulate": sim_launches, "score": score_launches},
        host_syncs_simulate_and_score=0,
        host_syncs_per_batch=len(batch_syncs), sync_sources=sorted(set(batch_syncs))[:6],
        score_peak_mem_gb=score_peak_gb)
    log("pdm_score_path launches", batches=PDM_BATCHES, **counts)
    return counts


LAP_N = 30   # boxes per sample in training (`num_bounding_boxes`)


def lap_costs() -> dict:
    """The LAP's inputs, (B, 30, 30) float32 numpy costs for B = 8 and 64
    from one seed: the first half of each batch normal, the second integer
    costs in [0, 4) (ties, where the tie-break decides)."""
    rng = np.random.default_rng(30)
    out = {}
    for B in (8, 64):
        costs = rng.normal(size=(B, LAP_N, LAP_N)).astype(np.float32)
        costs[B // 2:] = rng.integers(0, 4, size=(B - B // 2, LAP_N, LAP_N))
        out[B] = costs
    return out


def phase_lap(dev, build_logs: dict) -> dict:
    """The LAP kernel at n=30, B=8 and B=64, against its plain version on the
    card (exact) and scipy on the host (total cost). `critical_steps`: the
    longest chain of dependent steps over the batch (search steps plus
    augment hops), counted by the plain version on the card outside the
    timed window; `ns_per_step` the kernel's time over it."""
    from scipy.optimize import linear_sum_assignment

    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment, linear_sum_assignment_plain

    ptxas = [ln.strip() for ln in build_logs.get("lap", "").splitlines()
             if "registers" in ln or "spill" in ln]
    n = LAP_N
    summary = {}
    for B, costs in lap_costs().items():
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
        steps = torch.zeros(B, dtype=torch.long, device=dev)
        if not torch.equal(linear_sum_assignment_plain(c, steps), want):
            raise AssertionError(f"lap B={B}: the step counter changed the plain version's assignment")
        critical_steps = int(steps.max().item())

        def scipy_host():
            host = c.cpu().numpy()  # the copy and the sync the reference pays every step
            return [linear_sum_assignment(x)[1] for x in host]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            scipy_host()
        library_ms = (time.perf_counter() - t0) / 10 * 1e3
        bms, by = bound_ms(0.0, 4.0 * B * n * n + 4.0 * B * n, torch.float32)
        times = time_rows({"kernel_ms": lambda: batched_linear_sum_assignment(c)})
        plain = time_rows({"plain_ms": lambda: linear_sum_assignment_plain(c)}, iters=1, warmup=1)
        times["host_behind"] += plain.pop("host_behind")
        row = dict(shape=[B, n, n], ties_in=f"{B - B // 2} of {B} problems", path="warp_redux",
                   max_abs_err=0, host_syncs=0, scipy_max_rel_cost_gap=worst,
                   **times, **plain, library_ms=library_ms, library="scipy.optimize.linear_sum_assignment on the host, "
                   "with the device-to-host copy (not a PyTorch call)",
                   bound_ms=bms, bound_by=by, critical_steps=critical_steps,
                   mean_steps=float(steps.float().mean().item()),
                   ns_per_step=times["kernel_ms"] * 1e6 / critical_steps, ptxas=ptxas)
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
    with a float64 step on each as the witness (`entry.train_step_on`), at
    each of `COMPARISON_SEEDS` (`entry.comparison_batch`, the camera
    normalised on the host so every run reads the same input).

    Each float32 step takes the CPU float64 step's side at every ReLU, |x|
    and max-pool (`entry.Kinks`, impose): where an input lies within
    float32 rounding of a kink, a float32 step may take either side, and
    the gradients behind that unit then jump by all that it carries; that
    measures where the rounding fell, not the arithmetic (PERF.md §6).
    On the same side, per seed:

    - every ReLU and max-pool input of the card float32 steps (default and
      switched) and the CPU float32 step within `KINK_TOL` x max |float64|
      of the float64 step's, so a side is imposed only where the float32
      input is that close;
    - loss terms: card f32 vs CPU f32 within 1e-3 x max(1, |CPU|);
    - gradients, per parameter by relative L2 (`entry.grad_distances`):
      card f64 vs CPU f64 within 1e-6 (the card's arithmetic, with the
      conditioning of the model taken out); card f32, default and with both
      kernel switches on (`card_f32_fused`), vs CPU f64 within
      `entry.gradient_limits` of the CPU f32 step: min(1e-2 + 2 x its own
      distance, 0.1). On their own sides, ~100 ReLUs per full-width step
      fall the other way and move the gradients a median ~0.5% on every
      device; on float64's sides, ~3e-5 (PERF.md §6);
    - BN running statistics: card f32 vs CPU f32 within 1e-4 x max(1, |CPU|).

    The default card float32 step on its own sides keeps the gradient gate
    it held before the sides were imposed (against the CPU f32 step on its own sides).
    Logged, not gated: the switched step on its own sides, where each step
    took another side than float64 (`Kinks.summary`), the card f32 step
    with cuDNN off, and where each step's forward outputs leave the float64
    ones, module by module.
    """
    from diffusiondrive_torch.entry import (
        Kinks, build_model, comparison_batch, grad_distances, gradient_limits, output_distances, train_step_on)
    from diffusiondrive_torch.models.config import TransfuserConfig

    cfg, cfg_fused = TransfuserConfig(), _fused_config()
    model = build_model(cfg, torch.float32, seed=0).train()
    model_fused = build_model(cfg_fused, torch.float32, seed=0).train()
    model_fused.load_state_dict(model.state_dict())
    cpu = torch.device("cpu")
    counters = _launch_counters()
    for seed in COMPARISON_SEEDS:
        batch, ts, noise = comparison_batch(model, cfg, 2, seed=seed)
        ref_kinks = Kinks()
        t0 = time.perf_counter()
        ref = train_step_on(model, cfg, batch, ts, noise, cpu, torch.float64, record=True, kinks=ref_kinks)
        seconds = {"cpu_f64": time.perf_counter() - t0}
        runs, kinks = {}, {}
        # label: device, dtype, cuDNN, switched, on the float64 step's sides
        for label, d, dtype, cudnn, fused, same in (
                ("cpu_f32", cpu, torch.float32, True, False, True),
                ("card_f32", dev, torch.float32, True, False, True),
                ("card_f64", dev, torch.float64, True, False, True),
                ("card_f32_no_cudnn", dev, torch.float32, False, False, True),
                ("card_f32_fused", dev, torch.float32, True, True, True),
                ("cpu_f32_own_side", cpu, torch.float32, True, False, False),
                ("card_f32_own_side", dev, torch.float32, True, False, False),
                ("card_f32_fused_own_side", dev, torch.float32, True, True, False)):
            before = {k: f.launches for k, f in counters.items()}
            kinks[label] = Kinks(ref_kinks, impose=same)
            t0 = time.perf_counter()
            runs[label] = train_step_on(model_fused if fused else model, cfg_fused if fused else cfg, batch, ts,
                                        noise, d, dtype, cudnn=cudnn, record=same, kinks=kinks[label])
            seconds[label] = time.perf_counter() - t0
            launched = {k: f.launches - before[k] for k, f in counters.items()}
            if d.type == "cuda" and launched != STEP_LAUNCHES[fused]:
                raise AssertionError(f"train_path {label}: launches {launched}, want {STEP_LAUNCHES[fused]}")
        grads = {k: grad_distances(r["grads"], ref["grads"]) for k, r in runs.items()}
        limit = gradient_limits(runs["cpu_f32"]["grads"], ref["grads"])
        limit_own = gradient_limits(runs["cpu_f32_own_side"]["grads"], ref["grads"])
        over = {k: {p: v / (limit_own if k.endswith("own_side") else limit)[p] for p, v in grads[k].items()}
                for k in ("card_f32", "card_f32_fused", "card_f32_own_side", "card_f32_fused_own_side")}
        worst = {k: max(v.items(), key=lambda kv: kv[1]) for k, v in over.items()}
        kink_err = {k: kinks[k].summary(("relu", "max_pool2d"))["max_err"]
                    for k in ("cpu_f32", "card_f32", "card_f32_fused")}
        lc = runs["cpu_f32"]["losses"]
        loss_err = {k: {t: abs(runs[k]["losses"][t] - v) for t, v in lc.items()}
                    for k in ("card_f32", "card_f32_fused")}
        sc = runs["cpu_f32"]["stats"]
        bn_err = {k: max((runs[k]["stats"][t] - b).abs().max().item() / max(1.0, b.abs().max().item())
                         for t, b in sc.items()) for k in ("card_f32", "card_f32_fused")}
        worst64 = max(grads["card_f64"], key=grads["card_f64"].get)
        outs = {k: output_distances(r["outputs"], ref["outputs"]) for k, r in runs.items() if r["outputs"]}
        log(f"train_path f32 b2 seed {seed} kinks", kinks=len(ref_kinks.calls),
            **{k: k_.summary() for k, k_ in kinks.items() if k != "card_f64"})
        log(f"train_path f32 b2 seed {seed} card-vs-cpu", losses_cpu=lc, loss_max_abs_err=loss_err,
            params=len(ref["grads"]), seconds=seconds, kink_input_max_err=kink_err, kink_tol=KINK_TOL,
            grad_rel_l2_vs_cpu_f64={k: _quantiles(v.values()) for k, v in grads.items()},
            grad_worst_over_limit=worst, grad_card_f64_worst=[worst64, grads["card_f64"][worst64]],
            bn_stats_max_rel_err=bn_err, bn_tensors=len(sc))
        log(f"train_path f32 b2 fused seed {seed}", launches=STEP_LAUNCHES[True],
            loss_max_abs_err=max(loss_err["card_f32_fused"].values()),
            grad_rel_l2_vs_cpu_f64=_quantiles(grads["card_f32_fused"].values()),
            grad_worst_over_limit=worst["card_f32_fused"], own_side_worst_over_limit=worst["card_f32_fused_own_side"],
            bn_stats_max_rel_err=bn_err["card_f32_fused"])
        log(f"train_path f32 b2 seed {seed} losses", **{k: r["losses"] for k, r in runs.items()})
        log(f"train_path f32 b2 seed {seed} grads by part vs cpu_f64", order="backward",
            **{k: _by_group(v) for k, v in grads.items()})
        log(f"train_path f32 b2 seed {seed} forward outputs vs cpu_f64", modules=len(outs["cpu_f32"]),
            order="forward", **{k: {"first_above": {f"{t:g}": _first_above(v, t) for t in (1e-12, 1e-9, 1e-7,
                                                                                            1e-5, 1e-4)},
                                    "worst": max(v.items(), key=lambda kv: kv[1])} for k, v in outs.items()})
        for k, (where, op, err) in kink_err.items():
            if not err <= KINK_TOL:
                raise AssertionError(f"train_path f32 seed {seed} {k}: {op} input at {where} {err} of max "
                                     f"|float64| from the float64 step's > {KINK_TOL}")
        for k, errs in loss_err.items():
            for t, v in lc.items():
                if not errs[t] <= 1e-3 * max(1.0, abs(v)):
                    raise AssertionError(f"train_path f32 seed {seed} {k} {t}: card {runs[k]['losses'][t]} vs CPU {v}")
        if not grads["card_f64"][worst64] <= 1e-6:
            raise AssertionError(f"train_path f64 seed {seed} grad {worst64}: card vs CPU relative L2 "
                                 f"{grads['card_f64'][worst64]}")
        for k in ("card_f32", "card_f32_fused", "card_f32_own_side"):
            p, o = worst[k]
            if not o <= 1.0:
                raise AssertionError(f"train_path f32 seed {seed} {k} grad {p}: relative L2 to the CPU's float64 "
                                     f"step {grads[k][p]}, {o} of its limit")
        for k, e in bn_err.items():
            if not e <= 1e-4:
                raise AssertionError(f"train_path f32 seed {seed} {k} BN running statistics: max rel err {e} > 1e-4")


class _Counts:
    """Trainer callback: the kernel launch counters at each epoch's start and
    end, by phase."""

    def __init__(self):
        self.fns = _launch_counters()
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
    """`Trainer.fit` in bf16 at full width over a seeded cache, B=8 and B=64,
    under the default config and then with both kernel switches on (the
    same cache; dropout live). Returns the launch counts of the fits by path,
    "train_path" and "train_path_fused"."""
    from diffusiondrive_torch.agents.diffusiondrive.features import (
        TransfuserFeatureBuilder, TransfuserTargetBuilder)
    from diffusiondrive_torch.entry import build_model, write_example_cache
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.training.dataset import CacheOnlyDataset, batch_iterator
    from diffusiondrive_torch.training.train import OptimizerConfig, train_step
    from diffusiondrive_torch.training.trainer import Trainer

    launches = {"train_path": {}, "train_path_fused": {}}
    for B in (8, 64):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            t0 = time.perf_counter()
            write_example_cache(Path(tmp) / "cache", TransfuserConfig(), 3 * B, seed=B)
            cache_s = time.perf_counter() - t0
            for fused in (False, True):
                cfg = _fused_config() if fused else TransfuserConfig()
                name = f"train_path bf16 b{B}" + (" fused" if fused else "")
                out = Path(tmp) / ("out_fused" if fused else "out")
                ds = CacheOnlyDataset(str(Path(tmp) / "cache"), [TransfuserFeatureBuilder(cfg)],
                                      [TransfuserTargetBuilder(cfg)])
                counts = _Counts()
                opt = OptimizerConfig(epochs=2, warmup_epochs=1, steps_per_epoch=3, ema_decay=0.999)
                trainer = Trainer(build_model(cfg, torch.bfloat16, seed=0).to(dev), cfg, opt,
                                  output_dir=str(out), seed=0, callbacks=[counts])
                torch.cuda.reset_peak_memory_stats()
                for f in counts.fns.values():
                    f.launches = 0
                trainer.fit(lambda epoch: batch_iterator(ds, B, seed=epoch), 2,
                            val_batches=lambda epoch: batch_iterator(ds, B, shuffle=False),
                            validate_every_epochs=2, checkpoint_every_epochs=2)
                torch.cuda.synchronize()
                fit_counts = counts._now()
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                if not (out / "epoch_0001" / "state.pt").exists():
                    raise AssertionError(f"{name}: no checkpoint written")
                train_rows = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()
                              if '"train"' in ln]
                if len(train_rows) != 6 or not all(np.isfinite(v) for r in train_rows for v in r.values()
                                                   if isinstance(v, float)):
                    raise AssertionError(f"{name}: metrics rows {train_rows}")
                val = trainer.last_val_metrics
                if not val or not all(np.isfinite(v) for v in val.values()):
                    raise AssertionError(f"{name}: validation metrics {val}")
                for epoch in (0, 1):
                    want = {k: 3 * v for k, v in STEP_LAUNCHES[fused].items()}
                    if counts.delta[("train", epoch)] != want:
                        raise AssertionError(f"{name} train epoch {epoch}: launches "
                                             f"{counts.delta[('train', epoch)]} over 3 steps, want {want}")
                forwards = 3 * 2  # 3 batches, weights and EMA
                want = {k: forwards * v for k, v in VAL_LAUNCHES[fused].items()}
                if counts.delta[("val", 1)] != want:
                    raise AssertionError(f"{name} validation: launches {counts.delta[('val', 1)]} "
                                         f"over {forwards} forwards, want {want}")
                if fit_counts != {k: sum(d[k] for d in counts.delta.values()) for k in fit_counts}:
                    raise AssertionError(f"{name}: launches {fit_counts} outside the epochs")
                path = launches["train_path_fused" if fused else "train_path"]
                for k, v in fit_counts.items():
                    path[k] = path.get(k, 0) + v
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
                                           for k in fit_counts},
                           launches_val=counts.delta[("val", 1)])
                log(name, **row)
                del trainer, batch
                torch.cuda.empty_cache()
    return launches


def phase_train_path(dev) -> dict:
    """The training path: `Trainer.fit` in bf16 (the launch counts are set
    to 0 just before each fit and read just after it, summed over B=8 and
    B=64, by config), then the float32 card-vs-CPU steps."""
    counts = phase_train_bf16(dev)
    for path, c in counts.items():
        log(f"{path} launches", **c)
    phase_train_f32(dev)
    return counts


def _stage_sum(summary: dict, kernel: str) -> dict:
    """One attention kernel's bf16 masked rows summed over the four fusion
    stages' head widths: the time of one call per stage, as a train step
    makes them in each block."""
    rows = [summary[(kernel, D, "masked", torch.bfloat16)] for D in ATTN_D]
    out = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    backends = sorted({r["library_backend"] for r in rows})
    out["shape"] = (f"bf16 (B, H, T) = {ATTN_BHT}, p=0.1 mask, summed over D = {ATTN_D}; "
                    f"library_ms: scaled_dot_product_attention unmasked ({'/'.join(backends)})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import diffusiondrive_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_device().splitlines()[0]
    build_logs = phase_build()
    summary = phase_kernels(dev)
    summary.update(phase_attention(dev))
    summary.update(phase_conv3x3_train(dev))
    summary.update(phase_lap(dev, build_logs))
    counts = {**phase_main_path(dev), "agent_path": phase_agent_path(dev),
              "pdm_score_path": phase_pdm_score_path(dev, card), **phase_train_path(dev)}

    bf = torch.bfloat16
    kernels = []
    for name, key, row, src, replaces, errs in (
        ("stem_fused", "stem", summary[("stem", "camera", bf)], "diffusiondrive_torch/csrc/stem_fused.cu",
         "diffusiondrive_tpu/ops/stem_fused.py:95",
         [summary[("stem", lbl, bf)]["max_abs_err"] for lbl, _ in STEM_ROWS]),
        ("conv3x3_fused", "conv3x3", summary[("conv3x3", "image", "residual", bf)],
         "diffusiondrive_torch/csrc/conv3x3_fused.cu", "diffusiondrive_tpu/ops/conv_fused.py:55",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "conv3x3" and k[-1] == bf]),
        ("lidar_splat", "splat", summary[("lidar_splat", 16)], "diffusiondrive_torch/csrc/lidar_splat.cu",
         "diffusiondrive_tpu/ops/lidar_splat.py:47",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "lidar_splat"]),
        ("lap", "lap", summary[("lap", 64)], "diffusiondrive_torch/csrc/lap.cu",
         "diffusiondrive_tpu/ops/hungarian.py:138",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "lap"]),
        ("attention_fwd", "attention_fwd", _stage_sum(summary, "attention_fwd"),
         "diffusiondrive_torch/csrc/attention_fused.cu", "diffusiondrive_tpu/ops/attention_fused.py:78",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "attention_fwd" and k[-1] == bf]),
        ("attention_bwd", "attention_bwd", _stage_sum(summary, "attention_bwd"),
         "diffusiondrive_torch/csrc/attention_fused.cu", "diffusiondrive_tpu/ops/attention_fused.py:92",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "attention_bwd" and k[-1] == bf]),
    ):
        by_path = {path: c[key] for path, c in counts.items() if key in c}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": max(errs), "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "pass": True,
                        **{k: row[k] for k in ("library", "shape", "path", "library_conv_ms", "critical_steps",
                                               "ns_per_step", "plan") if k in row}})
    kernels[0]["rows"] = {label: {k: summary[("stem", label, bf)][k] for k in (
        "kernel_ms", "plain_ms", "bound_ms", "library_ms", "library_conv_ms", "path")} for label, _ in STEM_ROWS}
    kernels[1]["train_use"] = {f"{label} {part}": {k: summary[("conv3x3_train", label, part)][k] for k in (
        "kernel_ms", "plain_ms", "bound_ms", "library_ms", "path")} for label in ("image", "lidar") for part in ("fwd", "dx")}
    kernels[2]["rows"] = {" ".join(map(str, k[1:])): {f: v[f] for f in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
                          for k, v in summary.items() if k[0] == "lidar_splat"}
    kernels[3]["rows"] = {f"b{k[1]}": {f: v[f] for f in ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                                                         "critical_steps", "ns_per_step")}
                          for k, v in summary.items() if k[0] == "lap"}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
