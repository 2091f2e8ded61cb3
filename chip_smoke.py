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
               the backward's two launches) and for their three DP = 256
               counterparts (`WIDE_MMA_KERNELS`), the five (DP = 16 ... 256)
               of each float32 3xTF32 attention kernel (`TF32_KERNELS`),
               each of the four (residual, ReLU) of the bf16 and the
               float32 conv3x3 kernels (`CONV_MMA_KERNEL`,
               `CONV_TF32_KERNEL`) and each of the four (C = 1..4) of the
               bf16 and the float32 stem kernels (`STEM_MMA_KERNEL`,
               `STEM_TF32_KERNEL`), and for the LAP and splat kernels
               (`SINGLE_KERNELS`).
3. ``kernel``  each kernel at its main-path shapes (B=16, and the camera stem
               also at B=1; the conv kernels in bf16 and f32) against its
               plain PyTorch version (max abs error and the tolerance; the
               lidar splat must be exact and the same bits twice, on the
               agent path's clouds and on a uniform cloud, its rows naming
               `path` "segments" and the launch plan; stem and conv3x3 rows name their
               kernel in `path`, both on the tensor cores: "mma" for bf16
               products, "mma_tf32x3" for float32 in three TF32 products a
               product; bf16 rows also hold 2 bf16 ulps of max |plain|,
               two calls give the same bits, and
               `library_conv_ms` is the bare `F.conv2d`), timed beside
               the plain version, a library yardstick (`library_ms`, never
               used by the port) and the card's bound for the same work
               (`bound_ms`; float32's operations at the lesser of the f32
               FMA rate and three TF32 products a product). Every time in a
               kernel row comes from one timer, `time_rows`: the median of 3
               repeats, each the device time of
               launches queued behind a spin kernel (`queued_ms`: not the
               host's launch rate), the three beside it as `*_runs`.
               ``kernel attention_fwd`` / ``attention_bwd`` (the fused
               attention at the fusion blocks' B=64, H=4, T=320 and each
               stage's D = 16, 32, 64, 128, and ResNet-50's stage-3 D = 256
               (bf16 on the wide tensor-core kernels), bf16 and f32, without
               and with a p=0.1 keep mask; `path` names the kernel that ran,
               "mma" (bf16 products) or "mma_tf32x3" (f32 in three TF32
               products), both on the tensor cores, and every row carries
               its kernels' ptxas registers and spill bytes; library:
               `scaled_dot_product_attention` unmasked with its backend
               pinned, `SDPA_BACKEND`; one untimed pass over the first row
               first) and ``kernel conv3x3_train`` (its forward and input
               gradient at the B=64 layer-1 shapes in bf16, within 2 bf16
               ulps too, and in float32; the same bits twice; one autograd
               backward against the plain version's; library: cuDNN
               `conv2d` and `conv2d_input`, float32 in float32, TF32 off).
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
5c. ``metric_caching_path`` NAVSIM metric caching through the port's
               `planning/metric_caching.py:cache_data` on the card (default
               device): PDM-Closed at its full defaults (15 proposals = 3
               lateral paths x 5 IDM policies, 40 steps at 0.1 s, 96 track
               slots, 256 drivable polygons of 48 vertices, map radius 100
               m) on 64 scenes of four synthetic logs (`utils/synthetic.py`:
               two with a parked vehicle ahead, two free road) over the
               1440-object city grid of `tests/test_map_scale.py`
               (`city_map`), loaded by `SceneLoader` with its default
               arguments from a `.ddmap.pkl` under `NUPLAN_MAPS_ROOT`.
               Prints one planner call split out (the host's numpy part;
               the launches, busy ms and `time_rows` ms of its simulate
               and score; its host syncs, which must be exactly 1), the
               scenes/s of `cache_data` at 1 worker over the 64 scenes and
               at 8 over 32 of them (no token may fail, and both caches of
               a scene must hold the same poses), the card against the CPU
               on one scene of each log (proposals equal, scores within
               1e-4 x max(1, |CPU|), the same choice unless the CPU's top
               two are within 1e-4, `pdm_poses` equal), then the caches
               read back by `MetricCacheLoader` and scored with the bf16
               agent through `run_pdm_score_evaluation` (every row valid;
               1 splat, 2 stem and 12 conv3x3 launches per batch of 32,
               counted from 0 just before the run), with PDM-Closed's own
               mean score beside the agent's.
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
8. ``cli_path`` every ported entry point (`diffusiondrive_torch/script/run_*.py`)
               called in process with `--device` left at its default (the
               card), on two synthetic logs (16 scenes) whose blobs lie on
               disk as a real log's do (`write_cli_logs`: a 1920x1080 JPEG a
               camera; a 100000-point cloud a log, `binary` PCD in one and
               `binary_compressed` LZF in the other) and the city map of
               5c: `run_dataset_caching` (the DiffusionDrive agent's
               builders, full width), `run_training --config
               default_training` scene-backed in bf16 (B=4, 4 steps: finite
               losses, a checkpoint, exactly 1 LAP a step, the feature cache
               not rewritten), `run_metric_caching` (1 worker),
               `run_pdm_score` with the raw-sensor agent (exactly 1 splat, 2
               stem and 12 conv3x3 a batch), the constant-velocity agent's
               `run_pdm_score`, `run_create_submission_pickle` per log,
               `run_merge_submission_pickles` and
               `run_pdm_score_from_submission` (its CSV equal to the direct
               one cell for cell), then the agent's
               `run_create_submission_pickle` (finite predictions; 1 + 2 + 12
               launches a B=1 forward). Prints the sensor load of a scene by
               part (JPEG decode, PCD read, LZF), each CLI's wall seconds,
               peak memory and launches, and which LZF decoder ran (the
               native one must: no payload decoded in Python). Fails on any
               ERROR log record or invalid row.
9. ``ddp_path`` data parallelism, on `cli_path`'s logs and caches: a
               full-width step at B=16 in float32 and in bf16 on 2 spawned
               ranks (NCCL over two cards; on one card gloo with CUDA
               tensors) against 1 rank on the global batch (float32 terms
               within 1e-3 x max(1, |1 rank|), bf16 within 2e-2,
               agent_box_loss also 1e-2 relative; where the detection
               assignment differs on some rows, its two terms held to the
               1-rank assignment and each flip shown to be a near-tie; BN
               1e-4 in float32, 2e-2 in bf16; parameters the same bits on
               both ranks; 1 LAP launch a rank); `Trainer.fit` under DDP at
               world 1 on NCCL against the plain trainer (ms a step, plain,
               DDP, DDP, plain) with the gradient all-reduce's bytes and
               its bound over NVLink and PCIe for four cards; the runner
               with the float32 agent over a device list (every card, or
               [cuda:0, cuda:0] on one) against one device (rows within
               1e-4, 1 splat + 2 stem + 12 conv3x3 a chunk) and
               `lidar_bev` over the list (equal to one launch);
               `run_pdm_score --mesh-devices -1` (its CSV within 1e-4 of
               `cli_path`'s); `entry.dryrun_multichip(n)` over the n cards
               (golden loss, 7/12). The phase's launches include the
               spawned ranks'.
9b. ``variants_path`` every other model variant of the registry at full
               width (`phase_variants_path`: the MLP, UNet and ResNet-50
               nuScenes agents): float32 card vs CPU, bf16 agent frames/s
               at B=1 and B=16, a float32 train step card vs CPU, a bf16
               `Trainer.fit` (nuScenes also switched: 6 + 6 attention),
               `run_pdm_score` with the MLP and UNet agents on
               `cli_path`'s logs, `evaluate_nuscenes` card vs CPU; launch
               counts throughout (conv3x3: 12 a forward, 0 for ResNet-50);
               the 20-step vanilla-DDIM agent (`diffusiondrive_vanilla_ddim_agent`)
               through (a) and (b) only: its train step is the default
               agent's (`diffusion_test_steps` is read by the eval rollout
               alone), which `train_path` holds.
9c. ``capability_path`` the port's `script/run_capability_loop.py` at its
               defaults (`phase_capability_path`: 40 frames, B=8, 30 epochs,
               lr 1e-3, human replay): `ok` (trained PDMS above untrained by
               more than 0.1), PDMS, stage walls and launches by stage; each
               kernel the loop reaches held against its plain version on the
               inputs it gave the kernel; the splat at 64 bins on the loop's
               held-out clouds, exact.
9d. ``soak_path`` the port's `script/run_soak.py` at full width
               (`phase_soak_path`: B=8 bf16, EMA, a checkpoint every 50
               steps; `SOAK_STEPS_WHOLE` = 150 steps in the whole script, 200
               with ``--only soak_path``):
               `ok` (loss down, steady epochs, launches of an early and a
               late step equal, flat memory, the last checkpoint restores);
               the LAP held against its plain version on a step's costs.
10. a ``chip_smoke wall`` line (the script's seconds), a
               ``{"kernels": [...]}`` line (the attention entries with
               their D = 256 rows under ``resnet50_d256``), then
               ``{"ok": true, "device": {...}}`` last.

``python3 chip_smoke.py --only ddp_path`` runs phases 1, 2, 8 and 9 and
the last line only: on a machine of several cards, the check of the
data-parallel paths across them. ``--only variants_path`` runs phases 1,
2, 8 and 9b and the last line; ``--only capability_path`` and ``--only
soak_path`` run phases 1, 2 and that phase (the soak at its 200 steps) and
the last line; ``--only attention`` runs phases 1, 2, the attention rows
of phase 3 and the last line (the quick check of `csrc/attention_fused.cu`).

Any failure raises and exits non-zero; without a CUDA device it exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
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
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 tensor cores (NVIDIA data sheet)
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
    """(the least time the card could take for `flops` operations and `nbytes`
    bytes in `dtype`, ms; "operations" or "bytes", whichever binds). bf16
    operations at the bf16 tensor-core rate; float32 operations at float32
    accuracy, whichever way is faster: f32 FMAs outside the tensor cores, or
    three TF32 tensor-core products a product (3xTF32)."""
    if dtype == torch.bfloat16:
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
    else:
        t_ops = min(flops / PEAK_F32_FLOPS, 3.0 * flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
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
# their counterparts at DP = 256 (bf16 with 128 < D <= 256), no templates
WIDE_MMA_KERNELS = ("attn_fwd_mma_wide_kernel", "attn_bwd_dq_mma_wide_kernel", "attn_bwd_dkdv_mma_wide_kernel")
# the float32 attention kernels (3xTF32 on the tensor cores), each built for DP = 16, 32, 64, 128, 256
TF32_KERNELS = ("attn_fwd_tf32x3_kernel", "attn_bwd_dq_tf32x3_kernel", "attn_bwd_dkdv_tf32x3_kernel")
TF32_DP = (16, 32, 64, 128, 256)
# the conv3x3 kernels of `csrc/conv3x3_fused.cu` (bf16; float32 in 3xTF32), each built for (RES, RELU) in {0, 1}^2
CONV_MMA_KERNEL = "conv3x3_mma_kernel"
CONV_TF32_KERNEL = "conv3x3_tf32x3_kernel"
# the stem kernels of `csrc/stem_fused.cu` (bf16; float32 in 3xTF32), each built for C = 1, 2, 3, 4
STEM_MMA_KERNEL = "stem_mma_kernel"
STEM_TF32_KERNEL = "stem_tf32x3_kernel"
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
    wide = {k: ptxas_stats(logs["attention_fused"], k).get("") for k in WIDE_MMA_KERNELS}
    tf32 = {k: ptxas_stats(logs["attention_fused"], k) for k in TF32_KERNELS}
    conv = {k: ptxas_stats(logs["conv3x3_fused"], k) for k in (CONV_MMA_KERNEL, CONV_TF32_KERNEL)}
    stem = {k: ptxas_stats(logs["stem_fused"], k) for k in (STEM_MMA_KERNEL, STEM_TF32_KERNEL)}
    single = {k: ptxas_stats(logs[src], k).get("") for src, k in SINGLE_KERNELS.items()}
    log("build", seconds=round(time.time() - t0, 3), built=built,
        kernels=_build.kernel_names(), ptxas=stats[:24], attn_mma_regs_spills=mma,
        attn_wide_regs_spills=wide, attn_tf32_regs_spills=tf32, conv_regs_spills=conv, stem_regs_spills=stem,
        lap_splat_regs_spills=single)
    bad = {k: v for k, v in {**mma, **conv, **stem}.items()
           if len(v) != 4 or any(st or ld for _, st, ld in v.values())}
    if bad:
        raise AssertionError(f"tensor-core kernels: want 4 instantiations each with 0 spill bytes, got {bad}")
    bad = {k: v for k, v in tf32.items()
           if sorted(v) != sorted(map(str, TF32_DP)) or any(st or ld for _, st, ld in v.values())}
    if bad:
        raise AssertionError(f"float32 attention kernels: want DP = {TF32_DP}, each with 0 spill bytes, got {bad}")
    bad = {k: v for k, v in {**wide, **single}.items() if v is None or v[1] or v[2]}
    if bad:
        raise AssertionError(f"wide attention, LAP and splat kernels: want 0 spill bytes each, got {bad}")
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


def splat_library(ix: torch.Tensor, iy: torch.Tensor, bins: int):
    """The splat's library yardstick on the (B, N) bin indices: one
    `scatter_add_` of ones into a (B*bins^2 + 1) buffer, skipped points into
    the last (overflow) bucket, as `histogram2d_jax` does."""
    B = ix.shape[0]
    batch = torch.arange(B, device=ix.device)[:, None] * bins * bins
    flat = torch.where(ix >= 0, batch + ix.long() * bins + iy.long(), B * bins * bins).flatten()
    ones = torch.ones(flat.shape, device=ix.device)
    buf = torch.zeros(B * bins * bins + 1, device=ix.device)
    return lambda: buf.scatter_add_(0, flat, ones)


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
            ok = bx >= 0
            nbytes = 8.0 * B * SPLAT_N + 4.0 * B * bins * bins
            bms, by_what = bound_ms(0.0, nbytes, torch.float32)
            plan = splat_plan(B, SPLAT_N, bins, torch.cuda.get_device_properties(dev).multi_processor_count)
            row = dict(shape=[B, SPLAT_N], bins=bins, cloud=kind, path="segments", plan=plan._asdict(),
                       points_counted=int(ok.sum().item()), nonzero_bins=int((want > 0).sum().item()),
                       hottest_bin=int(want.max().item()), max_abs_err=err, same_bits_twice=True,
                       **time_rows({"kernel_ms": lambda: histogram2d(bx, by, bins),
                                    "plain_ms": lambda: histogram2d_plain(bx, by, bins),
                                    "library_ms": splat_library(bx, by, bins)}),
                       bound_ms=bms, bound_by=by_what)
            label = f"b{B}" if kind == "example" else f"{kind} b{B}"
            log(f"kernel lidar_splat {label}", **row)
            summary[("lidar_splat", B) if kind == "example" else ("lidar_splat", kind, B)] = row
    return summary


ATTN_BHT = (64, 4, 320)        # batch, heads, tokens of the fusion blocks at the CLI's batch
ATTN_D = (16, 32, 64, 128)     # head widths of fusion stages 1-4 (C / 4 for C = 64..512)
ATTN_D_R50 = (256,)            # ResNet-50's stage 3 (C = 1024), the widest the gate takes (stage 4's 512 is not)
# the stems at B=16, and the camera at B=1 (NAVSIM's per-scene call), NHWC
STEM_ROWS = (("camera", (16, 256, 1024, 3)), ("lidar", (16, 256, 256, 1)), ("camera b1", (1, 256, 1024, 3)))
CONV_EVAL = (("image", (16, 64, 256, 64)), ("lidar", (16, 64, 64, 64)))   # layer 1 at B=16, NHWC
CONV_TRAIN = (("image", (64, 64, 256, 64)), ("lidar", (64, 64, 64, 64)))  # layer 1 at B=64, NHWC
# the SDPA yardstick's backend, pinned: what SDPA picks on the H100 for the attention rows' shapes
SDPA_BACKEND = {torch.bfloat16: SDPBackend.CUDNN_ATTENTION, torch.float32: SDPBackend.EFFICIENT_ATTENTION}


def attention_regs_spills(logs: dict, backward: bool, D: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """{kernel: [registers, spill store bytes, spill load bytes]} from the
    build's ptxas log for the tensor-core kernels a call at head width D
    launches (`csrc/attention_fused.cu:dispatch`): bf16 at DP = 16, 32, 64,
    128 or the wide kernels past 128; float32 the 3xTF32 kernels at DP = 16
    ... 256."""
    dp = str(next(n for n in TF32_DP if D <= n))
    if dtype != torch.bfloat16:
        kernels, key = TF32_KERNELS, dp
    elif D > 128:
        kernels, key = WIDE_MMA_KERNELS, ""
    else:
        kernels, key = MMA_KERNELS, dp
    return {k: ptxas_stats(logs["attention_fused"], k).get(key) for k in (kernels[1:] if backward else kernels[:1])}


def phase_attention(dev, logs: dict) -> dict:
    """The fused attention kernels (forward, backward) at the fusion blocks'
    shapes (B=64, H=4, T=320, every stage's D, and ResNet-50's stage-3
    D = 256, which bf16 runs on the wide kernels) in bf16 and f32, without and
    with a p=0.1 keep mask, against their plain versions on the same inputs
    (bf16 also within 2 bf16 ulps of max |plain|, `check_bf16_ulps`):
    q, k, v and dO as (B, H, T, D) views of (B, T, H, D) memory, as the
    model hands them over. library_ms: `F.scaled_dot_product_attention`
    unmasked (forward; forward and backward through autograd), never called
    by the port, its backend pinned (`SDPA_BACKEND`). Times: `time_rows`,
    after one untimed pass over the first row.
    Bound (`bound_ms`; float32 at the lesser of f32 FMAs and 3xTF32): the
    forward's 4·B·H·T²·D flops and its q, k, v, o (and mask) bytes; the
    backward's 10·B·H·T²·D flops (the five products of a recomputing
    backward) and its q, k, v, dO, dq, dk, dv (and mask)."""
    from diffusiondrive_torch.ops.attention_fused import (
        attention_bwd_plain, attention_fwd_plain, backward_kernel, dropout_keep_mask, forward_kernel,
        fused_attention, fused_attention_bwd)

    B, H, T = ATTN_BHT
    gen, mask_gen = torch.Generator().manual_seed(4), torch.Generator(device=dev)
    summary, warm = {}, False
    for D in ATTN_D + ATTN_D_R50:
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
                           **time_rows(fwd_fns), library_backend=backend.name.lower(), bound_ms=bms, bound_by=by,
                           regs_spills=attention_regs_spills(logs, False, D, dtype))
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
                           bound_ms=bms, bound_by=by, regs_spills=attention_regs_spills(logs, True, D, dtype))
                log(f"kernel attention_bwd d{D} {variant}", **row)
                summary[("attention_bwd", D, variant, dtype)] = row
    return summary


def phase_conv3x3_train(dev) -> dict:
    """`conv3x3_train` at the layer-1 shapes of a B=64 train step, bf16 then
    float32: its forward and its input gradient (the conv3x3 kernel with the
    flipped, transposed weight) against the plain versions, the same bits
    twice; then one backward through autograd against the plain version's
    (dx and the library's dw). library_ms: cuDNN `F.conv2d` and
    `torch.nn.grad.conv2d_input` (float32 in float32: `main` turns TF32
    off)."""
    from diffusiondrive_torch.ops.conv_fused import (
        conv3x3_kernel, conv3x3_plain, conv3x3_train, conv3x3_train_plain, fused_conv3x3, to_hwio)

    gen = torch.Generator().manual_seed(5)
    one, zero = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    summary = {}
    for label, shape in CONV_TRAIN:
        B, H, W, _ = shape
        x0, g0 = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
        w0 = torch.randn(64, 64, 3, 3, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            x, g = (t.to(dev, dtype).permute(0, 3, 1, 2) for t in (x0, g0))
            w_oihw = (w0 / 24.0).to(dev, dtype)
            w = to_hwio(w_oihw, dtype)
            w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
            res = {}
            for name, fn in (("kernel", conv3x3_train), ("plain", conv3x3_train_plain)):
                xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
                fn(xl, wl).backward(g)
                res[name] = (xl.grad, wl.grad)
            torch.cuda.synchronize()
            auto_err = {n: check_close(f"conv3x3_train {label} autograd {n} {dtype}", a, b, TOL[dtype])[0]
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
                got, again, want = kern(), kern(), plain()
                torch.cuda.synchronize()
                tag = f"conv3x3_train {label} {part} {dtype}"
                err, limit = check_close(tag, got, want, TOL[dtype])
                ulps = check_bf16_ulps(tag, got, want) if dtype == torch.bfloat16 else None
                if not torch.equal(got, again):
                    raise AssertionError(f"{tag}: two calls gave different bits")
                del got, again, want
                row = dict(shape=list(shape), dtype=str(dtype), part=part, path=conv3x3_kernel(dtype),
                           max_abs_err=err, limit=limit, ulp_limit=ulps, autograd_max_abs_err=auto_err,
                           **time_rows({"kernel_ms": kern, "plain_ms": plain, "library_ms": lib}),
                           bound_ms=bms, bound_by=by)
                log(f"kernel conv3x3_train {label} {part}", **row)
                summary[("conv3x3_train", label, part, dtype)] = row
            del x, g, w, w_flip, w_oihw, res
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
    drive tailgating a 9 m/s lead car 12 m ahead, both proposals
    (`entry.golden_tailgating_scenes`); (b) 10 and 2 m/s towards a parked
    car 20 m ahead. A straight 16 m corridor (a roadblock and an on-route
    lane), 4 track slots, 26 local maps."""
    from diffusiondrive_torch.common.enums import MapLayer, StateIndex
    from diffusiondrive_torch.entry import golden_tailgating_scenes

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

    proposals, (_, *ctx) = golden_tailgating_scenes(1)
    tailgating = (proposals[0], *(a[0] for a in ctx))
    scenes = [tailgating, scene((20.0, 0.0, 0.0, 4.5, 2.0), (0.0, 0.0), (10.0, 2.0))]
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


def _runner_helpers():
    """(RecordingAgent, Loader, Errors) for driving `run_pdm_score_evaluation`
    with the raw-sensor agent on seeded inputs held in memory."""
    import logging

    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent

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
        """Every ERROR a logger reports: a quarantined token or the per-token
        fallback of the runner, a token `cache_data` failed."""

        def __init__(self):
            super().__init__(logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())

    return RecordingAgent, Loader, Errors


def phase_pdm_score_path(dev, card: str) -> dict:
    """NAVSIM scoring through the port's runner: `PDM_BATCHES` batches of
    `PDM_SCENES` raw-sensor scenes, the bf16 agent at full width and depth
    (seeded weights, default kernels), then simulation and scoring on the
    card; metric caches saved by `MetricCache.save` and read back by
    `MetricCacheLoader`. Returns the agent kernels' launch counts of the
    counted run (counts set to 0 just before it)."""
    import csv
    import logging

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

    RecordingAgent, Loader, Errors = _runner_helpers()

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


MC_GRID = (24, 12)     # city blocks (x, y) of `tests/test_map_scale.py`'s grid: 5 objects each, 1440 in all
MC_ROUTE = tuple(f"rb_0_{i}" for i in range(12))   # the logs' route: row 0 of the grid, x in [0, 600]
# (log name, ego speed m/s, parked vehicle's global x or None): IDM braking and the
# leading-agent search behind a parked vehicle, and free-road scenes
MC_LOGS = (("parked_40", 4.0, 40.0), ("parked_90", 4.0, 90.0), ("free", 4.0, None), ("free_fast", 8.0, None))
MC_SCENES_PER_LOG = 16   # 4 logs x 16 = 64 scenes, each a 14-frame window one frame apart
# `cache_data`'s thread pool: one thread over every scene, then its default of 8
# over half of each log's scenes (8 threads take ~4x longer a scene on one card)
MC_WORKERS = ((1, MC_SCENES_PER_LOG), (8, MC_SCENES_PER_LOG // 2))
MC_SPLIT_TOKEN = "parked_90_token_00003"   # the scene whose planner call is split out (its log's first)


def city_map(blocks_x: int = MC_GRID[0], blocks_y: int = MC_GRID[1], block_len: float = 50.0, width: float = 8.0):
    """The grid city of `tests/test_map_scale.py:make_city_map` as the port's
    `LocalMapAPI`: blocks_x * blocks_y roadblocks with one lane each (chained
    west to east along each row, 15 m/s), plus an intersection, a crosswalk
    and a walkway per block."""
    from diffusiondrive_torch.evaluate.observation import MapLayer
    from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData

    objects = []
    for j in range(blocks_y):
        y0 = j * 30.0
        for i in range(blocks_x):
            x0, x1 = i * block_len, (i + 1) * block_len
            rect = np.array([[x0, y0 - width / 2], [x1, y0 - width / 2], [x1, y0 + width / 2], [x0, y0 + width / 2]])
            rb, lane = f"rb_{j}_{i}", f"lane_{j}_{i}"
            objects.append(MapObjectData(
                token=rb, layer=MapLayer.ROADBLOCK, polygon=rect,
                outgoing=[f"rb_{j}_{i+1}"] if i + 1 < blocks_x else [],
                incoming=[f"rb_{j}_{i-1}"] if i > 0 else []))
            bx = np.arange(x0, x1 + 1.0, 2.0)
            objects.append(MapObjectData(
                token=lane, layer=MapLayer.LANE, polygon=rect,
                baseline=np.stack([bx, np.full_like(bx, y0), np.zeros_like(bx)], -1),
                outgoing=[f"lane_{j}_{i+1}"] if i + 1 < blocks_x else [],
                incoming=[f"lane_{j}_{i-1}"] if i > 0 else [], parent_token=rb, speed_limit=15.0))
            objects.append(MapObjectData(token=f"int_{j}_{i}", layer=MapLayer.INTERSECTION,
                                         polygon=rect + np.array([block_len / 2, 15.0])))
            objects.append(MapObjectData(token=f"cw_{j}_{i}", layer=MapLayer.CROSSWALK,
                                         polygon=rect * 0.2 + np.array([x0, y0 + 12.0])))
            objects.append(MapObjectData(token=f"ww_{j}_{i}", layer=MapLayer.WALKWAYS,
                                         polygon=rect + np.array([0.0, -14.0])))
    return LocalMapAPI(objects, "city")


def check_planner_choice(name: str, scores: np.ndarray, want: np.ndarray) -> int:
    """The proposal choice against the CPU's scores of the same proposals:
    the scores within PDM_TOL x max(1, |CPU|); the card's first maximum is
    the CPU's wherever the CPU's top-two gap exceeds PDM_TOL, and otherwise
    scores within PDM_TOL of the CPU's maximum. Returns the card's choice."""
    err = np.abs(scores.astype(np.float64) - want)
    if not (err <= PDM_TOL * np.maximum(1.0, np.abs(want))).all():
        raise AssertionError(f"{name}: scores {scores} vs the CPU's {want}")
    chosen, best = int(np.argmax(scores)), int(np.argmax(want))
    top2 = np.sort(want)[-2:]
    if (chosen != best if top2[1] - top2[0] > PDM_TOL else want[chosen] < want[best] - PDM_TOL):
        raise AssertionError(f"{name}: chose proposal {chosen}, the CPU {best} (scores {want})")
    return chosen


def phase_metric_caching_path(dev, card: str) -> dict:
    """NAVSIM metric caching through the port's `cache_data` on the card:
    PDM-Closed at its full defaults (15 proposals, 40 steps at 0.1 s, 96
    track slots, 256 drivable polygons of 48 vertices, map radius 100 m) on
    64 synthetic scenes (`utils/synthetic.py:build_synthetic_log`; parked
    vehicles ahead and free road) of the 1440-object city grid, loaded by
    `SceneLoader` with its default arguments from a `.ddmap.pkl` under
    `NUPLAN_MAPS_ROOT`. Then the caches are read back and scored with the
    bf16 agent through `run_pdm_score_evaluation`. Returns the agent
    kernels' launch counts of that run (counts set to 0 just before it)."""
    import logging

    import diffusiondrive_torch.common.dataclasses as scene_types
    from diffusiondrive_torch.common.dataclasses import SceneFilter, Trajectory, TrajectorySampling
    from diffusiondrive_torch.common.dataloader import MetricCacheLoader, SceneLoader
    from diffusiondrive_torch.entry import example_agent_input
    from diffusiondrive_torch.evaluate.pdm_score import score_scenes, simulate_and_score
    from diffusiondrive_torch.evaluate.runner import SUB_SCORE_COLUMNS, run_pdm_score_evaluation
    from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig
    from diffusiondrive_torch.evaluate.simulator import PDMSimulator
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops.attention_fused import fused_attention
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.ops.stem_fused import fused_stem
    from diffusiondrive_torch.planning.metric_caching import cache_data
    from diffusiondrive_torch.planning.pdm_closed.observation_builder import ego_state_array_from_scene
    from diffusiondrive_torch.planning.pdm_closed.planner import PDMClosedPlanner
    from diffusiondrive_torch.utils.synthetic import build_synthetic_log

    RecordingAgent, Loader, Errors = _runner_helpers()
    simulator = PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    maps_root = scene_types.NUPLAN_MAPS_ROOT
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mc_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        city = city_map()
        city.save(tmp / "maps" / "synthetic.ddmap.pkl")   # the logs' map_location
        for name, speed, obstacle in MC_LOGS:
            logs_dir, blobs_dir = build_synthetic_log(tmp / "data", num_frames=MC_SCENES_PER_LOG + 13, log_name=name,
                                                      speed=speed, obstacle_x=obstacle, roadblock_ids=MC_ROUTE)
        scene_types.NUPLAN_MAPS_ROOT = str(tmp / "maps")   # as the environment variable would set it
        try:
            loader = SceneLoader(logs_dir, blobs_dir, SceneFilter(frame_interval=1))
            tokens = sorted(loader.tokens)
            if len(tokens) != len(MC_LOGS) * MC_SCENES_PER_LOG:
                raise AssertionError(f"metric_caching_path: {len(tokens)} scenes")
            scene = loader.get_scene_from_token(MC_SPLIT_TOKEN)
            if scene.map_api is None or len(scene.map_api._objects) != len(city._objects):
                raise AssertionError("metric_caching_path: SceneLoader did not load the map")
            setup_s = time.perf_counter() - t0
            log("metric_caching_path setup", scenes=len(tokens), logs=[m[0] for m in MC_LOGS],
                map_objects=len(city._objects), setup_s=setup_s)

            # one planner call split out: the host's numpy part, then simulate
            # and score of its 15 proposals on the card
            planner = PDMClosedPlanner(device=dev)
            planner.compute_planner_trajectory(scene)   # the scorer's constant tables reach the card once
            split = {}
            score_on_card = planner._score_proposals

            def timed(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = score_on_card(*args)
                split["score_host_ms"] = (time.perf_counter() - t) * 1e3
                return out

            planner._score_proposals = timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            planner.compute_planner_trajectory(scene)
            split["planner_ms"] = (time.perf_counter() - t0) * 1e3
            del planner._score_proposals
            syncs = _syncs_in(lambda: planner.compute_planner_trajectory(scene))
            if len(syncs) != 1:
                raise AssertionError(f"metric_caching_path: {len(syncs)} host syncs in a planner call, want 1: {syncs[:4]}")
            inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in planner.scorer_inputs(planner.proposals, ego_state_array_from_scene(scene))]
            with torch.no_grad():
                run = lambda: simulate_and_score(simulator, PDMScorerConfig(), *inputs)  # noqa: E731
                times = time_rows({"simulate_and_score": run}, iters=3, warmup=1)
                launches, busy, top = _device_kernels(run)
            log("metric_caching_path scene", card=card, token=MC_SPLIT_TOKEN, proposals=len(planner.proposals),
                planner_ms=split["planner_ms"], host_numpy_ms=split["planner_ms"] - split["score_host_ms"],
                simulate_and_score_host_ms=split["score_host_ms"],
                simulate_and_score_device_ms=times["simulate_and_score"],
                simulate_and_score_runs=times["simulate_and_score_runs"], host_behind=times["host_behind"],
                simulate_and_score_busy_ms=busy, launches=launches, top_kernels_ms=top,
                host_syncs=len(syncs), sync_sources=syncs)

            # `cache_data` over every scene with one thread, then over half of
            # them with eight, each into its own directory; no token may fail
            errors = Errors()
            logging.getLogger("diffusiondrive_torch.planning.metric_caching").addHandler(errors)
            caches = {}
            for workers, per_log in MC_WORKERS:
                subset = sorted(t for name, *_ in MC_LOGS
                                for t in [u for u in tokens if u.startswith(f"{name}_token_")][:per_log])
                scenes = SceneLoader(logs_dir, blobs_dir, SceneFilter(frame_interval=1, tokens=subset))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                paths = cache_data(scenes, str(tmp / f"cache_w{workers}"), num_workers=workers)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                if errors.records or len(paths) != len(subset):
                    raise AssertionError(f"metric_caching_path: {len(subset) - len(paths)} failed tokens "
                                         f"at {workers} workers: {errors.records[:3]}")
                caches[workers] = MetricCacheLoader(tmp / f"cache_w{workers}")
                log(f"metric_caching_path cache_data w{workers}", card=card, scenes=len(subset), num_workers=workers,
                    scenes_per_s=len(subset) / wall_s, wall_s=wall_s, failed_tokens=0,
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            logging.getLogger("diffusiondrive_torch.planning.metric_caching").removeHandler(errors)
            if sorted(caches[1].tokens) != tokens:
                raise AssertionError(f"metric_caching_path: MetricCacheLoader found {len(caches[1].tokens)} caches")
            for tok in caches[8].tokens:
                if not np.array_equal(caches[1].get_from_token(tok).pdm_poses, caches[8].get_from_token(tok).pdm_poses):
                    raise AssertionError(f"metric_caching_path: {tok}: 1 and 8 workers cached other poses")

            # card vs CPU: the planner again on one scene of each log
            errs, chosen = [], {}
            for name, *_ in MC_LOGS:
                of_log = [t for t in tokens if t.startswith(f"{name}_token_")]
                tok = of_log[len(of_log) // 2]
                scene = loader.get_scene_from_token(tok)
                card_planner, cpu_planner = PDMClosedPlanner(device=dev), PDMClosedPlanner(device="cpu")
                poses, _ = card_planner.compute_planner_trajectory(scene)
                cpu_poses, _ = cpu_planner.compute_planner_trajectory(scene)
                if not np.array_equal(card_planner.proposals, cpu_planner.proposals):
                    raise AssertionError(f"metric_caching_path: {tok}: the card's proposals are not the CPU's")
                chosen[tok] = check_planner_choice(tok, card_planner.scores, cpu_planner.scores.astype(np.float64))
                errs.append(float(np.abs(card_planner.scores - cpu_planner.scores).max()))
                if not (np.array_equal(poses, cpu_poses) and np.array_equal(caches[1].get_from_token(tok).pdm_poses, poses)):
                    raise AssertionError(f"metric_caching_path: {tok}: pdm_poses differ from the CPU's")
            log("metric_caching_path card-vs-cpu", card=card, scenes=len(chosen), proposals_equal=True,
                max_abs_err=max(errs), tol_rel=PDM_TOL, chosen=chosen, pdm_poses_equal=True)
        finally:
            scene_types.NUPLAN_MAPS_ROOT = maps_root

        # every cache read back and scored with the bf16 agent
        cache_loader = caches[1]
        cfg = TransfuserConfig()
        inputs = {tok: example_agent_input(cfg, seed=i) for i, tok in enumerate(tokens)}
        agent = RecordingAgent(cfg, dtype=torch.bfloat16, seed=0, preprocess_on_device=True, device=dev)
        agent.trajectories = []
        errors = Errors()
        logging.getLogger("diffusiondrive_torch.evaluate.runner").addHandler(errors)
        torch.cuda.synchronize()
        fused_stem.launches = fused_conv3x3.launches = histogram2d.launches = fused_attention.launches = 0
        t0 = time.perf_counter()
        rows = run_pdm_score_evaluation(agent, Loader(inputs, tokens), cache_loader, simulator,
                                        batch_size=PDM_SCENES, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"splat": histogram2d.launches, "stem": fused_stem.launches,
                  "conv3x3": fused_conv3x3.launches, "attention_fwd": fused_attention.launches}
        logging.getLogger("diffusiondrive_torch.evaluate.runner").removeHandler(errors)
        batches = -(-len(tokens) // PDM_SCENES)
        if errors.records:
            raise AssertionError(f"metric_caching_path: the runner logged errors: {errors.records[:3]}")
        if counts != {"splat": batches, "stem": 2 * batches, "conv3x3": 12 * batches, "attention_fwd": 0}:
            raise AssertionError(f"metric_caching_path: launches {counts} over {batches} batches")
        if [r["token"] for r in rows] != tokens or not all(r["valid"] for r in rows):
            raise AssertionError(f"metric_caching_path: {sum(r['valid'] for r in rows)} valid rows of {len(rows)}")
        scores = np.array([[r[c] for c in SUB_SCORE_COLUMNS] for r in rows])
        if not np.isfinite(scores).all() or scores.min() < 0.0 or scores.max() > 1.0:
            raise AssertionError("metric_caching_path: sub-scores outside [0, 1]")
        trajs = [Trajectory(p) for batch in agent.trajectories for p in batch][: len(tokens)]
        both = score_scenes([cache_loader.get_from_token(t) for t in tokens], trajs, simulator, device=dev)
        if not np.allclose(both.score[:, 1], scores[:, -1], rtol=0, atol=PDM_TOL):
            raise AssertionError("metric_caching_path: the runner's rows are not the agent's scores")
        log("metric_caching_path scoring bf16", card=card, scenes=len(rows), batches=batches, valid_rows=len(rows),
            runner_s=wall_s, agent_mean_score=float(scores[:, -1].mean()),
            pdm_closed_mean_score=float(both.score[:, 0].mean()),
            mean_sub_scores=dict(zip(SUB_SCORE_COLUMNS, scores.mean(0).tolist())), launches=counts,
            inputs="seeded raw sensors in memory, caches written by cache_data")
    log("metric_caching_path launches", batches=batches, **counts)
    return counts


CLI_LOGS = (("cli_binary", "binary", 40.0), ("cli_compressed", "binary_compressed", None))  # (log, PCD mode, parked x)
CLI_SCENES_PER_LOG = 8   # 2 logs x 8 = 16 scenes, each a 14-frame window one frame apart
CLI_POINTS = 100_000     # points of a log's merged lidar sweep
CLI_TRAIN_BATCH = 4      # 16 scenes -> 4 train steps
CLI_TEAM = ("team_name=t", "authors=a", "email=e", "institution=i", "country=c")


def lzf_compress_reference(data: bytes) -> bytes:
    """Tiny LZF compressor (literal runs only) — valid LZF, no back-refs
    (copied from `tests/test_native.py`)."""
    out = bytearray()
    i = 0
    while i < len(data):
        run = min(32, len(data) - i)
        out.append(run - 1)
        out += data[i : i + run]
        i += run
    return bytes(out)


def write_cli_logs(root: Path) -> tuple:
    """Two synthetic OpenScene logs (`utils/synthetic.py`, the city route of
    `metric_caching_path`) whose blobs lie on disk as a real log's do: one
    1920x1080 JPEG per camera (a seeded smooth image with noise) and one
    `CLI_POINTS`-point cloud per log, as `binary` PCD in one log and
    `binary_compressed` (LZF) in the other. Returns (logs_dir, blobs_dir)."""
    import pickle

    import cv2

    from diffusiondrive_torch.entry import example_point_cloud
    from diffusiondrive_torch.utils.synthetic import CAM_NAMES, build_synthetic_log

    rng = np.random.default_rng(13)
    for name, _, obstacle in CLI_LOGS:
        logs_dir, blobs_dir = build_synthetic_log(root, num_frames=CLI_SCENES_PER_LOG + 13, log_name=name,
                                                  obstacle_x=obstacle, roadblock_ids=MC_ROUTE)
    for cam in CAM_NAMES:
        base = cv2.resize(rng.integers(0, 256, (34, 60, 3), dtype=np.uint8), (1920, 1080),
                          interpolation=cv2.INTER_CUBIC)
        img = np.clip(base.astype(np.int16) + rng.integers(-12, 13, base.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(blobs_dir / "cams" / f"{cam.lower()}.jpg"), img)
    fields = "x y z intensity ring lidar_id"
    for name, mode, _ in CLI_LOGS:
        pc = example_point_cloud(rng, CLI_POINTS)
        header = (f"VERSION 0.7\nFIELDS {fields}\nSIZE 4 4 4 4 4 4\nTYPE F F F F F F\nCOUNT 1 1 1 1 1 1\n"
                  f"WIDTH {CLI_POINTS}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {CLI_POINTS}\nDATA {mode}\n")
        with open(blobs_dir / "lidar" / f"{name}.pcd", "wb") as fp:
            fp.write(header.encode("ascii"))
            if mode == "binary":
                fp.write(pc.T.tobytes())
            else:   # column-major payload (all xs, then all ys, ...)
                payload = pc.tobytes()
                comp = lzf_compress_reference(payload)
                fp.write(np.array([len(comp), len(payload)], "<u4").tobytes() + comp)
        with open(logs_dir / f"{name}.pkl", "rb") as fp:
            frames = pickle.load(fp)
        for frame in frames:
            frame["lidar_path"] = f"lidar/{name}.pcd"
            for cam, spec in frame["cams"].items():
                frame["cams"][cam] = {**spec, "data_path": f"cams/{cam.lower()}.jpg"}
        with open(logs_dir / f"{name}.pkl", "wb") as fp:
            pickle.dump(frames, fp)
    return logs_dir, blobs_dir


def phase_cli_path(dev, card: str, root: Path) -> dict:
    """Every ported entry point, in process, with `--device` left at its
    default (the card), on two synthetic logs whose sensor blobs lie on
    disk (`write_cli_logs`) and the city map of `metric_caching_path`
    under `NUPLAN_MAPS_ROOT`: `run_dataset_caching` (the DiffusionDrive
    agent's builders at full width), `run_training --config
    default_training` scene-backed in bf16 (B=4, 4 steps), `run_metric_caching`
    (1 worker), `run_pdm_score` with the raw-sensor agent, the
    constant-velocity agent's `run_pdm_score`, two `run_create_submission_pickle`
    (one per log), `run_merge_submission_pickles` and
    `run_pdm_score_from_submission` (its CSV must equal the direct one
    cell for cell), and the agent's `run_create_submission_pickle`. Fails
    on any ERROR record, an invalid row, a non-finite loss or prediction,
    a launch count off (1 LAP a train step; 1 splat, 2 stem, 12 conv3x3 a
    scoring batch and a B=1 forward), a rewritten feature cache, or an
    LZF payload decoded in Python. The logs, caches and CSVs stay under
    `root` for `ddp_path`. Returns the launches of the whole phase."""
    import csv
    import logging
    import pickle

    import diffusiondrive_torch.common.dataclasses as scene_types
    from diffusiondrive_torch.common.dataclasses import _load_image, _lzf_decompress, load_pcd
    from diffusiondrive_torch.native import get_native
    from diffusiondrive_torch.script import (run_create_submission_pickle, run_dataset_caching,
                                             run_merge_submission_pickles, run_metric_caching, run_pdm_score,
                                             run_pdm_score_from_submission, run_training)

    from diffusiondrive_torch.ops.lidar_splat import histogram2d

    _, _, Errors = _runner_helpers()
    fns = {"splat": histogram2d, **_launch_counters()}
    maps_root = scene_types.NUPLAN_MAPS_ROOT
    errors = Errors()
    logging.getLogger().addHandler(errors)
    walls, peaks, launches = {}, {}, {}
    tmp = root
    t0 = time.perf_counter()
    logs_dir, blobs_dir = write_cli_logs(tmp / "data")
    city_map().save(tmp / "maps" / "synthetic.ddmap.pkl")
    split = tmp / "split.yaml"
    split.write_text("frame_interval: 1\n")
    for name, *_ in CLI_LOGS:
        (tmp / f"split_{name}.yaml").write_text(f"frame_interval: 1\nlog_names: [{name}]\n")
    setup_s = time.perf_counter() - t0

    # the sensor load of one scene of each log, by part
    cams = [blobs_dir / "cams" / f"{c}.jpg" for c in ("cam_l0", "cam_f0", "cam_r0")]
    load = {}
    for label, fn in (("jpeg_decode_ms", lambda: [_load_image(c) for c in cams]),
                      ("pcd_binary_ms", lambda: load_pcd(blobs_dir / "lidar" / "cli_binary.pcd")),
                      ("pcd_binary_compressed_ms", lambda: load_pcd(blobs_dir / "lidar" / "cli_compressed.pcd"))):
        fn()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        load[label] = (time.perf_counter() - t) / 3 * 1e3
    raw = (blobs_dir / "lidar" / "cli_compressed.pcd").read_bytes()
    body = raw[raw.find(b"\n", raw.find(b"DATA")) + 1:]
    comp, size = np.frombuffer(body[:8], "<u4")
    t = time.perf_counter()
    plain = _lzf_decompress(body[8:8 + int(comp)], int(size))
    load["lzf_ms"] = (time.perf_counter() - t) * 1e3
    # the loaders decode LZF natively whenever the library loads (else in Python, with a warning)
    if get_native() is None or len(plain) != CLI_POINTS * 24:
        raise AssertionError("cli_path: the native LZF decoder did not build or did not decode")
    load["lzf_mb"] = len(plain) / 1e6
    log("cli_path setup", card=card, logs=[m[0] for m in CLI_LOGS], scenes=len(CLI_LOGS) * CLI_SCENES_PER_LOG,
        points=CLI_POINTS, camera="1920x1080 JPEG", setup_s=setup_s, sensor_load_per_scene=load,
        jpeg_bytes=sum(c.stat().st_size for c in cams) // 3)

    def run(label, main, *argv):
        """One CLI in process: wall s, peak memory, launches."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in fns.values():
            f.launches = 0
        t = time.perf_counter()
        out = main(list(argv))
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t
        peaks[label] = torch.cuda.max_memory_allocated() / 1e9
        launches[label] = {k: f.launches for k, f in fns.items() if f.launches}
        if errors.records:
            raise AssertionError(f"cli_path: {label} logged errors: {errors.records[:3]}")
        return out

    scene_types.NUPLAN_MAPS_ROOT = str(tmp / "maps")   # as the environment variable would set it
    data = [f"navsim_log_path={logs_dir}", f"sensor_blobs_path={blobs_dir}", f"split={split}"]
    cache = tmp / "training_cache"
    try:
        run("run_dataset_caching", run_dataset_caching.main, "--config", "default_dataset_caching", *data,
            f"cache_path={cache}", f"output_dir={tmp / 'out_dataset'}")
        files = sorted(cache.glob("*/*/*.gz"))
        if len(files) != 2 * len(CLI_LOGS) * CLI_SCENES_PER_LOG:
            raise AssertionError(f"cli_path: {len(files)} feature/target files")
        stamps = [f.stat().st_mtime_ns for f in files]
        out = tmp / "out_training"
        run("run_training", run_training.main, "--config", "default_training", *data, f"cache_path={cache}",
            f"output_dir={out}", "epochs=1", f"batch_size={CLI_TRAIN_BATCH}")
        train_rows = [json.loads(r) for r in (out / "metrics.jsonl").read_text().splitlines()]
        steps = len(CLI_LOGS) * CLI_SCENES_PER_LOG // CLI_TRAIN_BATCH
        if len(train_rows) != steps or not all(np.isfinite(r["loss"]) for r in train_rows):
            raise AssertionError(f"cli_path: training rows {train_rows}")
        if not (out / "epoch_0000" / "state.pt").exists() or launches["run_training"].get("lap") != steps:
            raise AssertionError(f"cli_path: run_training launches {launches['run_training']}, or no checkpoint")
        if [f.stat().st_mtime_ns for f in files] != stamps:
            raise AssertionError("cli_path: run_training rewrote the feature cache")
        mc = tmp / "metric_cache"
        run("run_metric_caching", run_metric_caching.main, "--config", "default_metric_caching", data[0], data[2],
            f"metric_cache_path={mc}", f"output_dir={tmp / 'out_mc'}", "worker.max_workers=1")
        scores = {}
        for label, agent, batch in (("run_pdm_score", ["agent=diffusiondrive_agent",
                                                       "agent.preprocess_on_device=true"], 32),
                                    ("run_pdm_score cv", [], 16)):
            csv_path = run(label, run_pdm_score.main, "--config", "default_evaluation", *agent, *data,
                           f"metric_cache_path={mc}", f"output_dir={tmp / label.replace(' ', '_')}",
                           f"batch_size={batch}")
            with open(csv_path, newline="") as fp:
                scores[label] = list(csv.reader(fp))
            if len(scores[label]) != 18 or not all(r[2] == "True" for r in scores[label][1:]):
                raise AssertionError(f"cli_path: {label} rows {scores[label]}")
        if launches["run_pdm_score"] != {"splat": 1, "stem": 2, "conv3x3": 12}:
            raise AssertionError(f"cli_path: run_pdm_score launches {launches['run_pdm_score']}")
        subs = []
        for name, *_ in CLI_LOGS:
            subs.append(run(f"run_create_submission_pickle cv {name}", run_create_submission_pickle.main,
                            "--config", "default_submission", "agent=constant_velocity_agent", *data[:2],
                            f"split={tmp / f'split_{name}.yaml'}", f"output_dir={tmp / f'sub_{name}'}", *CLI_TEAM))
        run("run_merge_submission_pickles", run_merge_submission_pickles.main, *map(str, subs),
            "--output", str(tmp / "merged.pkl"))
        csv_path = run("run_pdm_score_from_submission", run_pdm_score_from_submission.main, "--submission",
                       str(tmp / "merged.pkl"), "--metric-cache-path", str(mc), "--output-dir",
                       str(tmp / "out_from_sub"), "--batch-size", "16")
        with open(csv_path, newline="") as fp:
            scores["run_pdm_score_from_submission"] = list(csv.reader(fp))
        if scores["run_pdm_score_from_submission"] != scores["run_pdm_score cv"]:
            raise AssertionError("cli_path: the submission-scored CSV is not run_pdm_score's")
        sub = run("run_create_submission_pickle", run_create_submission_pickle.main, "--config",
                  "default_submission", "agent=diffusiondrive_agent", "agent.preprocess_on_device=true", *data,
                  f"output_dir={tmp / 'sub_agent'}", *CLI_TEAM)
        with open(sub, "rb") as fp:
            preds = pickle.load(fp)["predictions"][0]
        n = len(CLI_LOGS) * CLI_SCENES_PER_LOG
        if len(preds) != n or not all(np.isfinite(t.poses).all() for t in preds.values()):
            raise AssertionError(f"cli_path: {len(preds)} agent predictions, or a non-finite one")
        if launches["run_create_submission_pickle"] != {"splat": n, "stem": 2 * n, "conv3x3": 12 * n}:
            raise AssertionError(f"cli_path: agent submission launches {launches['run_create_submission_pickle']}")
    finally:
        scene_types.NUPLAN_MAPS_ROOT = maps_root
        logging.getLogger().removeHandler(errors)
    total = {k: sum(c.get(k, 0) for c in launches.values())
             for k in ("lap", "splat", "stem", "conv3x3", "attention_fwd", "attention_bwd")}
    log("cli_path runs", card=card, wall_s=walls, phase_s=sum(walls.values()), peak_mem_gb=peaks,
        launches=launches, train_losses=[r["loss"] for r in train_rows],
        agent_mean_score=float(scores["run_pdm_score"][-1][-1]), cv_mean_score=float(scores["run_pdm_score cv"][-1][-1]),
        valid_rows=len(scores["run_pdm_score"]) - 2, submission_csv_equal=True, lzf_decoder="native")
    log("cli_path launches", **total)
    return total


DDP_B = 16                 # global batch of the full-width data-parallel step and fits
DDP_FIT_STEPS = 3          # steps an epoch of the timed fits (2 epochs: the second is timed)
DDP_SCENES = 8             # scenes of the runner over [cuda:0, cuda:0] (one batch: 2 chunks of 4)
DDP_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
DDP_LOSS_TOL = {"f32": 1e-3, "bf16": TOL[torch.bfloat16]}  # PERF.md §2's train-step and bf16 gates, x max(1, |1 rank|)
DDP_STATS_TOL = {"f32": 1e-4, "bf16": TOL[torch.bfloat16]}
DDP_BOX_REL = 1e-2         # JAX's tier for agent_box_loss (Hungarian near-ties), float32
ASSIGNED_TERMS = ("agent_class_loss", "agent_box_loss")   # the terms the detection assignment picks
RECOMPUTE_REL = 1e-4       # a run's assigned terms recomputed in float64 from its predictions and assignment
NVLINK_BYTES_PER_S = 450e9   # H100 SXM NVLink 4, one direction (900 GB/s both)
PCIE_BYTES_PER_S = 64e9      # PCIe Gen5 x16, one direction


def _ddp_batch(model, cfg, dev) -> dict:
    """`DDP_B` seeded training samples with the agent targets placed at
    `model`'s own train-forward predictions for the trainer's step-0 draws
    (dropout off), so the detection assignment is unique."""
    from diffusiondrive_torch.entry import example_training_sample, place_targets_at_predictions
    from diffusiondrive_torch.training.dataset import collate
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer

    rng = np.random.default_rng(21)
    batch = collate([example_training_sample(cfg, rng) for _ in range(DDP_B)])
    probe = copy.deepcopy(model).train()
    gen = Trainer(probe, cfg, OptimizerConfig(), seed=0).step_generator(0)
    timesteps, noise = probe.trajectory_head.train_draws(DDP_B, gen)
    with torch.no_grad():
        pred = probe(*(torch.from_numpy(batch[k]).to(dev) for k in ("camera_feature", "lidar_feature",
                                                                     "status_feature")),
                     timesteps=timesteps, diffusion_noise=noise)["agent_states"].float().cpu().numpy()
    return place_targets_at_predictions(batch, pred, rng)


@contextlib.contextmanager
def _detection_record():
    """Within: the train step's detection loss keeps what its assignment
    saw in the yielded dict (numpy): the predicted boxes ("states") and
    logits, the LAP's costs and its assignment ("cols")."""
    from diffusiondrive_torch.training import losses

    record = {}
    real_loss, real_lap = losses.agent_detection_loss, losses.batched_linear_sum_assignment

    def loss(targets, predictions, config):
        record["states"] = predictions["agent_states"].detach().double().cpu().numpy()
        record["logits"] = predictions["agent_labels"].detach().double().cpu().numpy()
        return real_loss(targets, predictions, config)

    def lap(cost):
        cols = real_lap(cost)
        record["cost"], record["cols"] = cost.double().cpu().numpy(), cols.long().cpu().numpy()
        return cols

    losses.agent_detection_loss, losses.batched_linear_sum_assignment = loss, lap
    try:
        yield record
    finally:
        losses.agent_detection_loss, losses.batched_linear_sum_assignment = real_loss, real_lap


def _assigned_terms(cfg, batch, record, cols=None) -> dict:
    """agent_class_loss and agent_box_loss as the trainer reports them
    (weighted, the box L1 over the global batch's count of valid agents),
    in float64 from a step's recorded predictions under its assignment or
    under `cols`."""
    cols = record["cols"] if cols is None else cols
    gt = batch["agent_states"].astype(np.float64)
    valid = batch["agent_labels"].astype(np.float64)
    gt_m = np.take_along_axis(gt, cols[..., None], 1)
    valid_m = np.take_along_axis(valid, cols, 1)
    l1 = np.abs(record["states"] - gt_m).sum(-1) * valid_m
    x = record["logits"]
    bce = np.maximum(x, 0.0) - x * valid_m + np.log1p(np.exp(-np.abs(x)))
    return {"agent_class_loss": cfg.agent_class_weight * bce.mean(),
            "agent_box_loss": cfg.agent_box_weight * l1.sum() / max(valid.sum(), 1.0)}


def _ddp_one_step(cfg, batch, dev, dtype, model=None) -> dict:
    """One `Trainer` step of `model` (default: the seeded full-width model
    in `dtype`; dropout off) on this process's rows of `batch` (all of it
    without a process group): the loss terms, the BN running statistics, a
    digest of the parameters, the LAP launches of the step, its wall ms and
    the detection loss's record (`_detection_record`)."""
    import hashlib

    from diffusiondrive_torch.entry import build_model
    from diffusiondrive_torch.models.layers import disable_dropout
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
    from diffusiondrive_torch.parallel.distributed import rank, world_size
    from diffusiondrive_torch.parallel.mesh import rank_rows
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer

    model = model if model is not None else build_model(cfg, dtype=dtype, seed=0).to(dev)
    disable_dropout(model)
    trainer = Trainer(model, cfg, OptimizerConfig(), seed=0)
    trainer.setup()
    rows = rank_rows(len(batch["status_feature"]), rank(), world_size())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    lap0 = batched_linear_sum_assignment.launches
    t0 = time.perf_counter()
    with _detection_record() as record:
        trainer.fit(lambda epoch: [{k: v[rows] for k, v in batch.items()}], 1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return {"metrics": trainer.last_train_metrics, "lap": batched_linear_sum_assignment.launches - lap0,
            "stats": {k: b.detach().float().cpu() for k, b in model.named_buffers() if "running" in k},
            "digest": digest.hexdigest(), "step_ms": step_ms, "rows": [rows.start, rows.stop],
            "record": record,
            "backend": torch.distributed.get_backend() if torch.distributed.is_initialized() else None}


def _bf16_ulps(diff: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|diff| in units of a bf16 ulp at |ref| (8 significant bits)."""
    exp = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    return np.abs(diff) / 2.0 ** (exp - 7)


def _check_assigned_terms(name, cfg, batch, one, got, rounding_ref=None) -> dict:
    """The detection terms of the 2-rank step against the 1-rank step.

    - Each run's reported terms are what its recorded predictions give
      under its own assignment with the global count of valid agents
      (`RECOMPUTE_REL`; the count local to a rank would give
      `local_count_box`).
    - Rows whose assignment of valid targets differs between the runs
      (invalid targets cost the same for every prediction, so their order is
      arbitrary and changes no term) are near-ties: the 1-rank cost of the
      2-rank assignment exceeds the 1-rank optimum by no more than
      ``2 n max |C2 - C1|``.
    - Held to the 1-rank assignment, the 2-rank predictions' terms equal
      the 1-rank terms within the step's gate; agent_box_loss in float32
      also within JAX's tier.
    - With `rounding_ref` (the float32 1-rank step's predicted boxes, for
      the bf16 step): the 2-rank boxes are no further from the 1-rank boxes,
      in mean |difference|, than twice the distance that bf16 rounding puts
      between the 1-rank boxes and float32's. At a random initialisation
      the agent head amplifies rounding (float32's 2-vs-1 boxes move by
      ~500 float32 ulps), so two bf16 runs give boxes metres apart; the
      targets sit 0.1 m from the 1-rank boxes, so the box term, an L1 of
      residuals of that size, moves by as much as the boxes do. There the
      held box term must stay within that move
      (``box weight x sum |p2 - p1| / count``) and the boxes' own gate is
      what holds it.
    Returns the figures, for the log."""
    rec1 = one["record"]
    rec2 = {k: np.concatenate([g["record"][k] for g in got]) for k in rec1}
    valid = batch["agent_labels"] > 0
    count = max(float(valid.sum()), 1.0)
    n = rec1["cols"].shape[-1]

    def matched(rec):
        return np.where(np.take_along_axis(valid, rec["cols"], 1), rec["cols"], -1)

    flipped = np.flatnonzero((matched(rec1) != matched(rec2)).any(-1))
    cost_err = float(np.abs(rec2["cost"] - rec1["cost"]).max())
    gaps = []
    for b in flipped:
        c1 = rec1["cost"][b]
        opt = c1[np.arange(n), rec1["cols"][b]].sum()
        gap = float(c1[np.arange(n), rec2["cols"][b]].sum() - opt)
        gaps.append(gap)
        if not gap <= 2 * n * cost_err + 1e-5 * max(1.0, abs(opt)):
            raise AssertionError(f"ddp_path {name}: row {b}'s 2-rank assignment costs {gap} over the 1-rank "
                                 f"optimum, more than 2 n max|C2 - C1| = {2 * n * cost_err}: not a near-tie")
    per_rank = [_assigned_terms(cfg, {k: v[slice(*g["rows"])] for k, v in batch.items()}, g["record"]) for g in got]
    held = _assigned_terms(cfg, batch, rec2, cols=rec1["cols"])
    diff = rec2["states"] - rec1["states"]
    valid_m = np.take_along_axis(valid, rec1["cols"], 1)
    gt_m = np.take_along_axis(batch["agent_states"].astype(np.float64), rec1["cols"][..., None], 1)
    move = cfg.agent_box_weight * (np.abs(diff).sum(-1) * valid_m).sum() / count
    ulps = _bf16_ulps(diff, rec1["states"])
    out = {"flipped_rows": flipped.tolist(), "flip_cost_gaps": gaps, "max_abs_cost_err": cost_err,
           "tie_bound": 2 * n * cost_err,
           "box_pred_err_over_max1": float((np.abs(diff) / np.maximum(1.0, np.abs(rec1["states"]))).max()),
           "box_pred_max_abs_diff": float(np.abs(diff).max()),
           "box_pred_bf16_ulps": {"median": float(np.median(ulps)), "max": float(ulps.max())},
           "box_pred_mean_abs_diff": float(np.abs(diff).mean()),
           "box_pred_mean_abs_rounding": None if rounding_ref is None else float(
               np.abs(rec1["states"] - rounding_ref).mean()),
           "box_residual_mean_1rank": float((np.abs(rec1["states"] - gt_m).sum(-1) * valid_m).sum() / count / 5),
           "held_to_1rank_assignment": held, "box_move_bound": float(move),
           "global_count_box": got[0]["metrics"]["agent_box_loss"],
           "local_count_box": float(np.mean([t["agent_box_loss"] for t in per_rank]))}
    for label, run, rec in (("1 rank", one, rec1), ("2 ranks", got[0], rec2)):
        mine = _assigned_terms(cfg, batch, rec)
        for k in ASSIGNED_TERMS:
            if not abs(mine[k] - run["metrics"][k]) <= RECOMPUTE_REL * max(1.0, abs(mine[k])):
                raise AssertionError(f"ddp_path {name}: {k} {run['metrics'][k]} on {label}, {mine[k]} from its "
                                     f"predictions and assignment with the global count ({out})")
    if rounding_ref is not None and not out["box_pred_mean_abs_diff"] <= 2 * out["box_pred_mean_abs_rounding"]:
        raise AssertionError(f"ddp_path {name}: predicted boxes further apart (2 ranks vs 1) than twice bf16's "
                             f"rounding ({out})")
    for k in ASSIGNED_TERMS:
        want = one["metrics"][k]
        limit = DDP_LOSS_TOL[name] * max(1.0, abs(want))
        if k == "agent_box_loss":
            limit = (max(limit, DDP_BOX_REL * abs(want)) if rounding_ref is None
                     else move + 1e-5 * max(1.0, abs(want)))
        if not abs(held[k] - want) <= limit:
            raise AssertionError(f"ddp_path {name}: {k} {held[k]} from the 2-rank predictions under the 1-rank "
                                 f"assignment, {want} on 1 rank (limit {limit}; {out})")
    return out


def _ddp_rank(rank_, world, dev, cfg, batch_paths) -> dict:
    """A spawned rank of `ddp_path`: its float32 and bf16 steps on its rows
    of the global batches (one file a type)."""
    out = {}
    for name, path in batch_paths.items():
        with np.load(path) as f:
            batch = {k: f[k] for k in f.files}
        out[name] = _ddp_one_step(cfg, batch, dev, DDP_DTYPES[name])
    return out


def _timed_fits(base, cfg, batch, dev, distributed: bool) -> tuple:
    """`Trainer.fit` of a copy of `base`, 2 epochs of `DDP_FIT_STEPS` steps
    on `batch`; under a 1-rank NCCL group when `distributed`. Returns (the
    second epoch's ms a step, the LAP launches of the fit)."""
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
    from diffusiondrive_torch.parallel.distributed import free_tcp_address, initialize_distributed
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer

    if distributed:
        initialize_distributed(free_tcp_address(), 1, 0, device=dev)
    try:
        counts = _Counts()
        trainer = Trainer(copy.deepcopy(base), cfg, OptimizerConfig(), seed=0, callbacks=[counts])
        if distributed and trainer.state is None:
            trainer.setup()
            if trainer.state.ddp is None:
                raise AssertionError("ddp_path: the trainer did not wrap the model under a process group")
        lap0 = batched_linear_sum_assignment.launches
        trainer.fit(lambda epoch: [batch] * DDP_FIT_STEPS, 2)
        return counts.wall[("train", 1)] / DDP_FIT_STEPS * 1e3, batched_linear_sum_assignment.launches - lap0
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def phase_ddp_path(dev, card: str, cli_root: Path) -> dict:
    """Data parallelism on the card (`parallel/`, DDP in `training/trainer.py`,
    device lists in the agent, `batched_pdm_score` and the runner):

    (a) one bf16 train step at full width on a global batch of `DDP_B`: 2
    spawned ranks (NCCL over 2 cards where the machine has them; on one
    card gloo with CUDA tensors, since NCCL refuses two ranks on one card)
    against 1 rank on the whole batch in this process (the float32 step
    too): every loss term within the bf16 gate x max(1, |1 rank|)
    (agent_box_loss also within JAX's 1e-2 tier); where the detection
    assignment of some rows differs, the two assigned terms are held to the
    1-rank assignment instead and the flips to near-ties
    (`_check_assigned_terms`); the BN running statistics within the bf16
    gate, the parameters the same bits on both ranks, 1 LAP launch a rank;
    (b) `Trainer.fit` at B=`DDP_B` under a 1-rank NCCL group (DDP) against
    the plain `Trainer` (plain, DDP, DDP, plain): the second epoch's ms a
    step; the gradient all-reduce's bytes a step and their bound over
    NVLink and PCIe for four cards;
    (c) `run_pdm_score_evaluation` with the float32 agent over a device
    list (every card where the machine has two or more, else
    [cuda:0, cuda:0]) against one device on `DDP_SCENES` scenes: rows within
    1e-4, discrete sub-scores equal, 1 splat, 2 stem and 12 conv3x3
    launches on each chunk; `lidar_bev` over the list equal to one launch;
    (d) `run_pdm_score --mesh-devices -1` on `cli_path`'s logs and caches:
    its CSV within 1e-4 of `cli_path`'s one-device CSV;
    (e) `entry.dryrun_multichip(n)` over the n visible cards (one NCCL rank
    on one card): the golden loss, 7/12.
    Returns the phase's launches, the spawned ranks' included."""
    import csv

    from diffusiondrive_torch.common.dataloader import MetricCacheLoader
    from diffusiondrive_torch.entry import build_model, dryrun_multichip, example_agent_input
    from diffusiondrive_torch.evaluate.runner import SUB_SCORE_COLUMNS, run_pdm_score_evaluation
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.models.layers import disable_dropout
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.ops.preprocessing import lidar_bev
    from diffusiondrive_torch.parallel.distributed import launch
    from diffusiondrive_torch.script import run_pdm_score

    RecordingAgent, Loader, Errors = _runner_helpers()
    fns = {"splat": histogram2d, **_launch_counters()}
    for f in fns.values():
        f.launches = 0
    phase_t0 = time.perf_counter()
    cfg = TransfuserConfig()
    cards = torch.cuda.device_count()

    # (a) 2 ranks against 1 rank on the global batch, float32 and bf16
    models = {name: build_model(cfg, dtype=dt, seed=0).to(dev) for name, dt in DDP_DTYPES.items()}
    for m in models.values():
        disable_dropout(m)
    batches = {name: _ddp_batch(m, cfg, dev) for name, m in models.items()}
    base = copy.deepcopy(models["bf16"])
    one = {name: _ddp_one_step(cfg, b, dev, DDP_DTYPES[name], models.pop(name)) for name, b in batches.items()}
    torch.cuda.empty_cache()
    two_device, backend = ("cuda", "nccl") if cards >= 2 else (str(dev), "gloo")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        paths = {}
        for name, b in batches.items():
            paths[name] = str(Path(tmp) / f"batch_{name}.npz")
            np.savez(paths[name], **b)
        t0 = time.perf_counter()
        ranks = launch(_ddp_rank, 2, args=(cfg, paths), device=two_device, backend=backend, timeout=600)
        launch_s = time.perf_counter() - t0
    lap_ranks = [sum(r[name]["lap"] for name in DDP_DTYPES) for r in ranks]
    for name, want_one in one.items():
        got = [r[name] for r in ranks]
        if want_one["lap"] != 1 or [g["lap"] for g in got] != [1, 1]:
            raise AssertionError(f"ddp_path {name}: LAP launches {[g['lap'] for g in got]} on the ranks, "
                                 f"{want_one['lap']} on 1 rank; want 1 each")
        if got[0]["digest"] != got[1]["digest"] or got[0]["metrics"] != got[1]["metrics"]:
            raise AssertionError(f"ddp_path {name}: the ranks' parameters or loss terms differ: "
                                 f"{[(g['digest'], g['metrics']) for g in got]}")
        assignment = _check_assigned_terms(name, cfg, batches[name], want_one, got,
                                           one["f32"]["record"]["states"] if name == "bf16" else None)
        loss_err, gated = {}, {}
        for k, want in want_one["metrics"].items():
            err = abs(got[0]["metrics"][k] - want)
            loss_err[k] = err / max(1.0, abs(want))
            limit = DDP_LOSS_TOL[name] * max(1.0, abs(want))
            if k in ASSIGNED_TERMS and assignment["flipped_rows"]:
                # another assignment on some rows: `_check_assigned_terms` holds
                # these terms to the 1-rank assignment and the flips to near-ties
                limit = None
            elif k == "agent_box_loss":
                limit = max(limit, DDP_BOX_REL * abs(want))
            gated[k] = limit is not None
            if limit is not None and not err <= limit:
                raise AssertionError(f"ddp_path {name}: {k} {got[0]['metrics'][k]} on 2 ranks, {want} on 1 "
                                     f"(limit {limit})")
        stats_err = max(((got[0]["stats"][k] - v).abs().max() / v.abs().max().clamp_min(1.0)).item()
                        for k, v in want_one["stats"].items())
        if not stats_err <= DDP_STATS_TOL[name]:
            raise AssertionError(f"ddp_path {name}: BN running statistics {stats_err} apart (2 ranks vs 1)")
        b = batches[name]
        log(f"ddp_path step {name} 2-vs-1", card=card, cards=cards, backend=got[0]["backend"],
            rank_device=two_device, global_batch=DDP_B, rank_rows=[g["rows"] for g in got],
            loss_1rank=want_one["metrics"]["loss"], loss_2ranks=got[0]["metrics"]["loss"],
            err_over_max1=loss_err, gated=gated, limit=DDP_LOSS_TOL[name], box_rel_limit=DDP_BOX_REL,
            assigned_terms={k: [want_one["metrics"][k], got[0]["metrics"][k]] for k in ASSIGNED_TERMS},
            assignment=assignment,
            bn_stats_err=stats_err,
            bn_stats_limit=DDP_STATS_TOL[name], params_equal_across_ranks=True, lap_per_rank=[1, 1],
            step_ms_1rank=want_one["step_ms"], step_ms_ranks=[g["step_ms"] for g in got],
            valid_agents_per_rank=[float(b["agent_labels"][slice(*g["rows"])].sum()) for g in got],
            note="correctness run, not a rate: the step_ms include the first step's setup")
    log("ddp_path spawn", launch_s=launch_s, ranks=2, rank_device=two_device, backend=backend)

    # (b) the DDP wrapper's cost at world 1 (NCCL) against the plain Trainer
    tensors = batches["bf16"]
    times = {"plain": [], "ddp": []}
    fit_lap = 0
    for mode in ("plain", "ddp", "ddp", "plain"):
        ms, lap = _timed_fits(base, cfg, tensors, dev, mode == "ddp")
        times[mode].append(ms)
        fit_lap += lap
        if lap != 2 * DDP_FIT_STEPS:
            raise AssertionError(f"ddp_path: {mode} fit made {lap} LAP launches over {2 * DDP_FIT_STEPS} steps")
    params = sum(p.numel() for p in base.parameters())
    grad_bytes = 4 * params
    ring = 2 * (4 - 1) / 4 * grad_bytes      # bytes each card sends in a ring all-reduce over 4 cards
    med = {k: float(np.median(v)) for k, v in times.items()}
    log("ddp_path fit bf16 world1", card=card, batch=DDP_B, steps_timed=DDP_FIT_STEPS, ms_per_step=med,
        runs_ms=times, samples_per_s={k: DDP_B / v * 1e3 for k, v in med.items()},
        ddp_over_plain=med["ddp"] / med["plain"], order="plain, ddp, ddp, plain", backend="nccl",
        params=params, grad_allreduce_bytes_per_step=grad_bytes, ring_bytes_per_card_4cards=ring,
        allreduce_bound_ms_4cards={"nvlink": ring / NVLINK_BYTES_PER_S * 1e3, "pcie_gen5": ring / PCIE_BYTES_PER_S * 1e3})
    del base
    torch.cuda.empty_cache()

    # (c) the runner over a device list against one device
    mesh = [torch.device("cuda", i) for i in range(cards)] if cards >= 2 else [dev, dev]
    tokens = [f"ddp_{i:02d}" for i in range(DDP_SCENES)]
    rows, runner_counts = {}, {}
    errors = Errors()
    import logging

    logging.getLogger("diffusiondrive_torch.evaluate.runner").addHandler(errors)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_pdm_") as tmp:
        for i, tok in enumerate(tokens):
            pdm_road_cache(tok, seed=100 + i).save(Path(tmp) / "cache" / "chip_smoke_road" / tok / "metric_cache.npz")
        inputs = {tok: example_agent_input(cfg, seed=100 + i) for i, tok in enumerate(tokens)}
        agent = RecordingAgent(cfg, dtype=torch.float32, seed=0, preprocess_on_device=True, device=dev)
        agent.trajectories = []
        for name, devices in (("one", None), ("two", mesh)):
            before = {k: f.launches for k, f in fns.items()}
            rows[name] = run_pdm_score_evaluation(agent, Loader(inputs, tokens), MetricCacheLoader(Path(tmp) / "cache"),
                                                  batch_size=DDP_SCENES, device=dev, mesh=devices)
            torch.cuda.synchronize()
            runner_counts[name] = {k: f.launches - before[k] for k, f in fns.items() if f.launches - before[k]}
    logging.getLogger("diffusiondrive_torch.evaluate.runner").removeHandler(errors)
    if errors.records:
        raise AssertionError(f"ddp_path: the runner logged errors {errors.records[:3]}")
    k = len(mesh)
    if runner_counts["one"] != {"splat": 1, "stem": 2, "conv3x3": 12} or \
            runner_counts["two"] != {"splat": k, "stem": 2 * k, "conv3x3": 12 * k}:
        raise AssertionError(f"ddp_path: runner launches {runner_counts}; want 1 + 2 + 12 on each chunk")
    row_err = 0.0
    for a, b in zip(rows["two"], rows["one"]):
        if a["token"] != b["token"] or not (a["valid"] and b["valid"]):
            raise AssertionError(f"ddp_path: rows {a} / {b}")
        for c in SUB_SCORE_COLUMNS:
            row_err = max(row_err, abs(a[c] - b[c]))
        for c in ("no_at_fault_collisions", "drivable_area_compliance", "time_to_collision_within_bound",
                  "comfort", "driving_direction_compliance"):
            if a[c] != b[c]:
                raise AssertionError(f"ddp_path: {c} {a[c]} over two devices, {b[c]} on one")
    traj_err = float(np.abs(agent.trajectories[1] - agent.trajectories[0]).max())
    if row_err > 1e-4 or traj_err > MAIN_TOL:
        raise AssertionError(f"ddp_path: runner rows {row_err}, trajectories {traj_err} apart")
    gen = torch.Generator(device=dev).manual_seed(3)
    points = (torch.rand((DDP_SCENES, SPLAT_N, 3), generator=gen, device=dev) - 0.5) * 80.0
    valid = torch.rand((DDP_SCENES, SPLAT_N), generator=gen, device=dev) < 0.9
    before = histogram2d.launches
    bev_one = lidar_bev(points, valid, cfg)
    bev_mesh = lidar_bev(points, valid, cfg, mesh=mesh)
    bev_launches = histogram2d.launches - before
    if bev_launches != 1 + k or bev_mesh.device != dev or not torch.equal(bev_mesh, bev_one):
        raise AssertionError(f"ddp_path: lidar_bev over {mesh} differs from one launch ({bev_launches} launches)")
    log("ddp_path runner f32 over a device list", card=card, mesh=[str(d) for d in mesh], scenes=DDP_SCENES,
        chunks=k, max_abs_row_err=row_err, max_abs_trajectory_err=traj_err, launches=runner_counts,
        per_chunk={"splat": 1, "stem": 2, "conv3x3": 12}, lidar_bev_mesh_equal=True, lidar_bev_launches=bev_launches)

    # (d) the CLI's --mesh-devices -1 on cli_path's logs and caches
    (want_csv,) = sorted((cli_root / "run_pdm_score").glob("*.csv"))
    data = [f"navsim_log_path={cli_root / 'data' / 'logs'}", f"sensor_blobs_path={cli_root / 'data' / 'blobs'}",
            f"split={cli_root / 'split.yaml'}"]
    before = {k: f.launches for k, f in fns.items()}
    t0 = time.perf_counter()
    got_csv = run_pdm_score.main(["--config", "default_evaluation", "agent=diffusiondrive_agent",
                                  "agent.preprocess_on_device=true", *data,
                                  f"metric_cache_path={cli_root / 'metric_cache'}",
                                  f"output_dir={cli_root / 'run_pdm_score_mesh'}", "batch_size=32",
                                  "--mesh-devices", "-1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = {k: f.launches - before[k] for k, f in fns.items() if f.launches - before[k]}
    tables = []
    for path in (got_csv, want_csv):
        with open(path, newline="") as fp:
            tables.append(list(csv.reader(fp)))
    csv_err = 0.0
    for g, w in zip(*tables):
        if g[:3] != w[:3]:
            raise AssertionError(f"ddp_path: --mesh-devices -1 CSV row {g} vs {w}")
        for a, b in zip(g[3:], w[3:]):
            if a != b:
                csv_err = max(csv_err, abs(float(a) - float(b)))
    if len(tables[0]) != len(tables[1]) or csv_err > 1e-4 or cli_counts != {"splat": cards, "stem": 2 * cards,
                                                                            "conv3x3": 12 * cards}:
        raise AssertionError(f"ddp_path: --mesh-devices -1 CSV {csv_err} apart, launches {cli_counts}")
    log("ddp_path cli --mesh-devices -1", card=card, devices=cards, wall_s=cli_s, rows=len(tables[0]) - 2,
        max_abs_csv_err=csv_err, launches=cli_counts)

    # (e) the dry run on an NCCL rank a card
    t0 = time.perf_counter()
    dry = dryrun_multichip(cards)
    dry_s = time.perf_counter() - t0
    log(f"ddp_path dryrun_multichip({cards})", card=card, wall_s=dry_s, **{k: dry[k] for k in (
        "backend", "loss", "eval_score", "lap_launches", "max_abs_trajectory_diff")},
        golden_loss=dry["golden"]["loss"])

    counts = {k: f.launches for k, f in fns.items()}
    counts["lap"] += sum(lap_ranks) + sum(dry["lap_launches"])
    log("ddp_path launches", phase_s=time.perf_counter() - phase_t0, spawned_rank_lap=sum(lap_ranks) + sum(
        dry["lap_launches"]), **counts)
    return counts


VARIANT_TRAIN_B = 8       # the bf16 `Trainer.fit` of each variant: 2 steps at this batch
VARIANT_ITERS = {1: 5, 16: 3}   # timed agent calls at B=1 (compute_trajectory) and B=16 (forward)
# variants that differ from `diffusiondrive_agent` in the eval rollout only (`diffusion_test_steps`):
# their train step is the default agent's, which `train_path` holds; (c) and (d) skip them
EVAL_ONLY_VARIANTS = ("diffusiondrive_vanilla_ddim_agent",)


def _variant_outputs_ok(name: str, out: dict, batch: int, cfg) -> None:
    """Every output finite, at the shapes of the variant's head."""
    shapes = {"trajectory": (batch, cfg.num_poses, 3), "agent_states": (batch, 30, 5), "agent_labels": (batch, 30),
              "bev_semantic_map": (batch, 128, 256, 7)}
    if "poses_reg" in out:
        shapes.update(poses_reg=(batch, cfg.ego_fut_mode, cfg.num_poses, 3), poses_cls=(batch, cfg.ego_fut_mode))
    if set(out) != set(shapes):
        raise AssertionError(f"variants_path {name}: outputs {sorted(out)}, want {sorted(shapes)}")
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(torch.as_tensor(out[k]).float()).all():
            raise AssertionError(f"variants_path {name} {k}: shape {tuple(out[k].shape)} (want {shape}) or non-finite")


def phase_variants_path(dev, card: str, cli_root: Path) -> dict:
    """Every model variant of the registry beside `diffusiondrive_agent`
    (`entry.VARIANTS`: `transfuser_agent`, the MLP head;
    `diffusion_policy_agent`, the diffusion-policy UNet with its 20-step
    DDIM; `diffusiondrive_nuscenes_agent`, ResNet-50 encoders, 6 poses,
    k-means anchors; `diffusiondrive_vanilla_ddim_agent`, the default model
    with a 20-step DDIM rollout, through (a) and (b) only, `EVAL_ONLY_VARIANTS`)
    at full width, seeded weights, through the entry points:

    (a) float32 B=1 planner forward on the card against the CPU, the noise
        fixed (`MAIN_TOL` x max(1, |CPU|)): 2 stem and 12 conv3x3 launches
        (ResNet-50: 0 conv3x3, its Bottleneck takes the module path, as JAX's);
    (b) the bf16 raw-sensor agent (`entry.agent_entry`): `compute_trajectory`
        at B=1 (`forward` for the 6-pose nuScenes agent, whose
        `compute_trajectory` raises in both packages: NAVSIM's `Trajectory`
        holds 8 poses) and `forward` at B=16, frames/s on the host clock with the
        copy and with the inputs on the card; 1 splat, 2 stem, 12 or 0
        conv3x3 a forward;
    (c) one float32 train step at B=2, seed 5 (`entry.comparison_batch`:
        a detection assignment unique by `MIN_ASSIGNMENT_MARGIN`;
        `entry.train_step_on`) on the card and the CPU, each also in
        float64: the card's float32 losses within 1e-3 x max(1, |v|) of the
        CPU's float32 ones and of the CPU's float64 ones, card float64
        gradients within 1e-6 relative L2 of the CPU's; 1 LAP a card step;
        logged: each step's assignment margin and whether it matched every
        valid target as the CPU float64 step did;
    (d) a bf16 `Trainer.fit` of 2 steps at B=8: 1 LAP a step, finite losses;
        for nuScenes also one switched step (`fused_attention_mode="on"`,
        `fused_conv_mode="train"`): 6 attention forwards and 6 backwards
        (stages 1-3; stage 4's D = 512 fails the gate and takes the module
        path, as in JAX), no conv3x3;
    (e) `run_pdm_score` with `agent=transfuser_agent` and with
        `diffusion_policy_agent` on `cli_path`'s logs and metric cache: every
        row valid, 1 splat, 2 stem, 12 conv3x3 a batch;
    (f) `evaluate_nuscenes` on the card over the nuScenes agent's 6-pose
        outputs of (b) against seeded GT and agent boxes, equal to the
        CPU's within 1e-6;
    (g) `run_training --config default_training` of each variant on
        `cli_path`'s logs (scene-backed, bf16, one epoch of 2 steps at B=8;
        the MLP and UNet agents on `cli_path`'s cache, the nuScenes agent
        caching its own 6-pose targets): finite losses, a checkpoint, 1 LAP
        a step.

    The counters are set to 0 at the phase's start and read at its end;
    they must equal the launches counted step by step. Returns them."""
    import csv
    import dataclasses

    from diffusiondrive_torch.agents.diffusiondrive.features import RawSensorFeatureBuilder
    from diffusiondrive_torch.entry import (
        VARIANTS, agent_entry, assignment_margin, build_model, comparison_batch, example_agent_input,
        example_inputs, example_training_sample, grad_distances, train_step_on, variant_config)
    from diffusiondrive_torch.evaluate.nuscenes_metrics import evaluate_nuscenes
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.script import run_pdm_score
    from diffusiondrive_torch.training.dataset import collate
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer

    fns = {"splat": histogram2d, **_launch_counters()}
    want = {k: 0 for k in fns}

    def counted():
        torch.cuda.synchronize()
        return {k: f.launches for k, f in fns.items()}

    def delta(before):
        now = counted()
        return {k: now[k] - before[k] for k in fns if now[k] - before[k]}

    phase_t0 = time.perf_counter()
    for f in fns.values():
        f.launches = 0
    cpu = torch.device("cpu")
    raw_inputs = [example_agent_input(seed=300 + b) for b in range(16)]
    builder = RawSensorFeatureBuilder(variant_config("transfuser_agent")[1])
    feats = [builder.compute_features(a) for a in raw_inputs]
    batches = {1: {k: np.asarray(v)[None] for k, v in feats[0].items()},
               16: {k: np.stack([f[k] for f in feats]) for k in feats[0]}}
    del feats
    nuscenes_traj = None
    summary = {}
    for name in sorted(VARIANTS):
        head, cfg = variant_config(name)
        conv = 0 if cfg.image_architecture == "resnet50" else 12
        t_var = time.perf_counter()

        # (a) float32 B=1: card with the kernels vs CPU with the plain versions
        model_cpu = build_model(cfg, torch.float32, seed=0, trajectory_head_type=head)
        noise = model_cpu.trajectory_head.draw_noise(1, torch.Generator().manual_seed(0))
        inputs = example_inputs(cfg, 1, cpu, seed=1)
        with torch.no_grad():
            model_gpu = copy.deepcopy(model_cpu).to(dev)
            before = counted()
            out_gpu = model_gpu(**{k: v.to(dev) for k, v in inputs.items()},
                                diffusion_noise=None if noise is None else noise.to(dev))
            got = delta(before)
            if got != {"stem": 2, **({"conv3x3": conv} if conv else {})}:
                raise AssertionError(f"variants_path {name} f32 forward: launches {got}, want 2 stem, {conv} conv3x3")
            want["stem"] += 2
            want["conv3x3"] += conv
            out_cpu = model_cpu(**inputs, diffusion_noise=noise)
        _variant_outputs_ok(name, out_gpu, 1, cfg)
        errs = {k: check_close(f"variants_path {name} f32 {k}", out_gpu[k].cpu(), out_cpu[k], MAIN_TOL)[0]
                for k in out_cpu}
        log(f"variants_path {name} f32 b1 card-vs-cpu", card=card, head=head, backbone=cfg.image_architecture,
            poses=cfg.num_poses, max_abs_err=errs, tol_rel=MAIN_TOL, launches=got)
        del model_gpu, out_gpu

        # (b) the bf16 raw-sensor agent: compute_trajectory at B=1, forward at B=16. A 6-pose
        # agent's compute_trajectory raises in both packages (it builds NAVSIM's 8-pose
        # `Trajectory`): the nuScenes agent is called through `forward` at B=1 too
        navsim = cfg.num_poses == 8
        agent, _ = agent_entry(dev, torch.bfloat16, seed=0, num_points=1024, config=cfg, trajectory_head_type=head)
        rows = {}
        with torch.no_grad():
            for batch, iters in VARIANT_ITERS.items():
                features = batches[batch]
                before = counted()
                tensors = agent.features_to_device(features)
                for _ in range(2):
                    out = agent.predict(tensors)
                _variant_outputs_ok(name, out, batch, cfg)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(iters):
                    out = agent.predict(tensors)
                torch.cuda.synchronize()
                dev_s = (time.perf_counter() - t0) / iters
                t0 = time.perf_counter()
                for _ in range(iters):
                    if batch == 1 and navsim:
                        traj = agent.compute_trajectory(raw_inputs[0])
                    else:
                        out_np = agent.forward(features)
                e2e_s = (time.perf_counter() - t0) / iters
                forwards = 2 + 2 * iters
                got = delta(before)
                if got != {"splat": forwards, "stem": 2 * forwards, **({"conv3x3": conv * forwards} if conv else {})}:
                    raise AssertionError(f"variants_path {name} bf16 b{batch}: launches {got} over {forwards} "
                                         f"forwards, want 1 splat, 2 stem, {conv} conv3x3 each")
                for k, n in (("splat", 1), ("stem", 2), ("conv3x3", conv)):
                    want[k] += n * forwards
                if batch == 1 and navsim and (traj.poses.shape != (8, 3) or not np.isfinite(traj.poses).all()):
                    raise AssertionError(f"variants_path {name}: compute_trajectory {traj.poses.shape}")
                if batch == 16 or not navsim:
                    _variant_outputs_ok(name, out_np, batch, cfg)
                    if name == "diffusiondrive_nuscenes_agent":
                        nuscenes_traj = out_np["trajectory"]
                rows[batch] = dict(call="compute_trajectory" if batch == 1 and navsim else "forward",
                                   frames_per_s_on_card=batch / dev_s, ms_per_call_on_card=dev_s * 1e3,
                                   frames_per_s_with_copy=batch / e2e_s, ms_per_call_with_copy=e2e_s * 1e3,
                                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                                   launches_per_forward={k: v // forwards for k, v in got.items()})
                log(f"variants_path {name} bf16 b{batch}", card=card, **rows[batch])
        del agent

        summary[name] = {"fps_b1_with_copy": rows[1]["frames_per_s_with_copy"],
                         "fps_b16_with_copy": rows[16]["frames_per_s_with_copy"]}
        if name in EVAL_ONLY_VARIANTS:   # its train step is the default agent's (train_path)
            summary[name]["wall_s"] = time.perf_counter() - t_var
            continue

        # (c) one float32 train step at B=2 (seed 5): card vs CPU, each also in float64
        model = model_cpu.train()
        tbatch, ts, tnoise = comparison_batch(model, cfg, 2, seed=5)
        runs, seconds = {}, {}
        for label, d, dtype in (("cpu_f32", cpu, torch.float32), ("card_f32", dev, torch.float32),
                                ("cpu_f64", cpu, torch.float64), ("card_f64", dev, torch.float64)):
            t0 = time.perf_counter()
            runs[label] = train_step_on(model, cfg, tbatch, ts, tnoise, d, dtype, record=True)
            seconds[label] = time.perf_counter() - t0
            if d.type == "cuda":
                if runs[label]["lap_launches"] != 1:
                    raise AssertionError(f"variants_path {name} {label}: {runs[label]['lap_launches']} LAP launches")
                want["lap"] += 1
        lc, l64, lcard = (runs[k]["losses"] for k in ("cpu_f32", "cpu_f64", "card_f32"))
        loss_err = {t: abs(lcard[t] - v) for t, v in lc.items()}
        loss_err_f64 = {t: abs(lcard[t] - v) for t, v in l64.items()}
        valid = torch.from_numpy(tbatch["agent_labels"]).bool()
        matches = {k: [{int(j): i for i, j in enumerate(r["assignment"]["cols"][b].tolist()) if valid[b, j]}
                       for b in range(len(valid))] for k, r in runs.items()}
        margins = {k: [assignment_margin(r["assignment"]["cost"][b], r["assignment"]["cols"][b].long(), valid[b])
                       for b in range(len(valid))] for k, r in runs.items()}
        g64 = grad_distances(runs["card_f64"]["grads"], runs["cpu_f64"]["grads"])
        g32 = {k: grad_distances(runs[k]["grads"], runs["cpu_f64"]["grads"]) for k in ("cpu_f32", "card_f32")}
        worst64 = max(g64, key=g64.get)
        log(f"variants_path {name} train f32 b2 seed 5 card-vs-cpu", card=card, losses_cpu=lc, losses_cpu_f64=l64,
            loss_max_abs_err=loss_err, loss_max_abs_err_vs_cpu_f64=loss_err_f64, tol_rel=1e-3,
            assignment_margin=margins, matched_as_cpu_f64={k: v == matches["cpu_f64"] for k, v in matches.items()},
            grad_card_f64_worst=[worst64, g64[worst64]],
            grad_rel_l2_vs_cpu_f64={k: _quantiles(v.values()) for k, v in g32.items()},
            grad_worst_vs_cpu_f64={k: max(v.items(), key=lambda kv: kv[1]) for k, v in g32.items()},
            params=len(g64), seconds=seconds)
        for t, v in lc.items():
            if not (loss_err[t] <= 1e-3 * max(1.0, abs(v)) and loss_err_f64[t] <= 1e-3 * max(1.0, abs(l64[t]))):
                raise AssertionError(f"variants_path {name} train {t}: card {lcard[t]} vs CPU {v}, "
                                     f"CPU float64 {l64[t]}")
        if not g64[worst64] <= 1e-6:
            raise AssertionError(f"variants_path {name} train f64 grad {worst64}: relative L2 {g64[worst64]}")
        del runs, model, model_cpu

        # (d) bf16 Trainer.fit: 2 steps at B=8 (and, for nuScenes, one switched step)
        rng = np.random.default_rng(7)
        fit_batches = [collate([example_training_sample(cfg, rng) for _ in range(VARIANT_TRAIN_B)]) for _ in range(2)]
        fits = [("default", cfg, fit_batches, {"lap": 2})]
        if cfg.image_architecture == "resnet50":
            fits.append(("switched", dataclasses.replace(cfg, fused_attention_mode="on", fused_conv_mode="train"),
                         fit_batches[:1], {"lap": 1, "attention_fwd": 6, "attention_bwd": 6}))
        for label, fcfg, fb, expect in fits:
            trainer = Trainer(build_model(fcfg, torch.bfloat16, seed=0, trajectory_head_type=head).to(dev), fcfg,
                              OptimizerConfig(epochs=1, warmup_epochs=1, steps_per_epoch=len(fb)), seed=0)
            before = counted()
            t0 = time.perf_counter()
            trainer.fit(lambda epoch: fb, 1)
            got = delta(before)
            fit_s = time.perf_counter() - t0
            metrics = trainer.last_train_metrics
            if got != expect or not metrics or not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"variants_path {name} fit {label}: launches {got} (want {expect}), "
                                     f"metrics {metrics}")
            for k, n in got.items():
                want[k] += n
            log(f"variants_path {name} fit bf16 b{VARIANT_TRAIN_B} {label}", card=card, steps=len(fb),
                wall_s=fit_s, ms_per_step_with_first=fit_s / len(fb) * 1e3, launches=got, train_metrics=metrics)
            del trainer
        torch.cuda.empty_cache()
        summary[name]["wall_s"] = time.perf_counter() - t_var

    # (e) run_pdm_score with the MLP and UNet agents on cli_path's logs and caches
    import logging

    errors = _runner_helpers()[2]()
    logging.getLogger().addHandler(errors)
    data = [f"navsim_log_path={cli_root / 'data' / 'logs'}", f"sensor_blobs_path={cli_root / 'data' / 'blobs'}",
            f"split={cli_root / 'split.yaml'}"]
    for name, agent_args in (("transfuser_agent", ["agent=transfuser_agent"]),
                             ("diffusion_policy_agent", ["agent=diffusiondrive_agent", "agent.name=diffusion_policy_agent"])):
        before = counted()
        t0 = time.perf_counter()
        csv_path = run_pdm_score.main(["--config", "default_evaluation", *agent_args, "agent.preprocess_on_device=true",
                                       *data, f"metric_cache_path={cli_root / 'metric_cache'}",
                                       f"output_dir={cli_root / ('run_pdm_score_' + name)}", "batch_size=32"])
        got = delta(before)
        wall = time.perf_counter() - t0
        with open(csv_path, newline="") as fp:
            rows_csv = list(csv.reader(fp))
        if len(rows_csv) != 18 or not all(r[2] == "True" for r in rows_csv[1:]):
            raise AssertionError(f"variants_path run_pdm_score {name}: rows {rows_csv}")
        if got != {"splat": 1, "stem": 2, "conv3x3": 12} or errors.records:
            raise AssertionError(f"variants_path run_pdm_score {name}: launches {got}, errors {errors.records[:3]}")
        for k, n in got.items():
            want[k] += n
        log(f"variants_path run_pdm_score {name}", card=card, wall_s=wall, rows=len(rows_csv) - 2,
            mean_score=float(rows_csv[-1][-1]), launches=got)

    # (g) run_training (scene-backed, bf16, 1 epoch) of each variant on cli_path's logs;
    # the nuScenes agent's builders write their own cache (6-pose targets)
    import diffusiondrive_torch.common.dataclasses as scene_types
    from diffusiondrive_torch.script import run_training

    maps_root, scene_types.NUPLAN_MAPS_ROOT = scene_types.NUPLAN_MAPS_ROOT, str(cli_root / "maps")
    steps = 16 // VARIANT_TRAIN_B
    try:
        for name, agent_args, cache in (
                ("transfuser_agent", ["agent=transfuser_agent"], "training_cache"),
                ("diffusion_policy_agent", ["agent=diffusiondrive_agent", "agent.name=diffusion_policy_agent"],
                 "training_cache"),
                ("diffusiondrive_nuscenes_agent", ["agent=diffusiondrive_nuscenes_agent"], "training_cache_nuscenes")):
            out = cli_root / f"run_training_{name}"
            before = counted()
            t0 = time.perf_counter()
            run_training.main(["--config", "default_training", *agent_args, *data, f"cache_path={cli_root / cache}",
                               f"output_dir={out}", "epochs=1", f"batch_size={VARIANT_TRAIN_B}"])
            got = delta(before)
            wall = time.perf_counter() - t0
            train_rows = [json.loads(r) for r in (out / "metrics.jsonl").read_text().splitlines()]
            if (len(train_rows) != steps or not all(np.isfinite(r["loss"]) for r in train_rows)
                    or got != {"lap": steps} or not (out / "epoch_0000" / "state.pt").exists() or errors.records):
                raise AssertionError(f"variants_path run_training {name}: rows {train_rows}, launches {got}, "
                                     f"errors {errors.records[:3]}")
            want["lap"] += steps
            log(f"variants_path run_training {name}", card=card, wall_s=wall, steps=steps, cache=cache,
                losses=[r["loss"] for r in train_rows], launches=got)
    finally:
        scene_types.NUPLAN_MAPS_ROOT = maps_root
        logging.getLogger().removeHandler(errors)

    # (f) nuScenes metrics on the card over the nuScenes agent's 6-pose outputs
    rng = np.random.default_rng(11)
    n, T = nuscenes_traj.shape[:2]
    gt = np.concatenate([nuscenes_traj[..., :2] + rng.normal(0, 1.0, (n, T, 2)), nuscenes_traj[..., 2:]],
                        -1).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-20, 20, (n, T, 8, 2)), rng.uniform(-np.pi, np.pi, (n, T, 8, 1)),
                            rng.uniform(3.5, 5.0, (n, T, 8, 1)), rng.uniform(1.6, 2.2, (n, T, 8, 1))],
                           -1).astype(np.float32)
    valid = rng.uniform(size=(n, T, 8)) < 0.5
    metrics = evaluate_nuscenes(nuscenes_traj, gt, boxes, valid)
    metrics_cpu = evaluate_nuscenes(nuscenes_traj, gt, boxes, valid, device="cpu")
    err = max(abs(metrics[k] - metrics_cpu[k]) for k in metrics_cpu)
    if set(metrics) != set(metrics_cpu) or not err <= 1e-6 or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"variants_path evaluate_nuscenes: card {metrics} vs CPU {metrics_cpu}")
    log("variants_path evaluate_nuscenes", card=card, scenes=n, poses=T, metrics=metrics, max_abs_err_vs_cpu=err)

    counts = counted()
    if {k: v for k, v in counts.items() if v} != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"variants_path: launches {counts}, counted step by step {want}")
    log("variants_path launches", card=card, phase_s=time.perf_counter() - phase_t0, variants=summary, **counts)
    return counts


def hold_recorded_kernels(path: str, store: dict, card: str) -> dict:
    """Each kernel's recorded inputs (`entry.recording_kernel_calls`) through
    the kernel twice and its plain version: the LAP exact; the stem and
    conv3x3 within `TOL` (bf16: and 2 bf16 ulps), the same bits twice; timed
    beside the plain version (`time_rows`), the library yardstick (as in
    `phase_kernels` and `phase_lap`: cuDNN's conv with the affine folded in,
    then ReLU (+ residual) and pool; scipy on the host for the LAP) and the
    bound. One row a (kernel, shape, dtype, residual), logged and returned
    by key. The plain solver's calls ("lap_plain", past the kernel's
    `MAX_N`) launch no kernel and are not held."""
    from diffusiondrive_torch.ops.conv_fused import conv3x3_kernel, conv3x3_plain, fused_conv3x3
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment, linear_sum_assignment_plain
    from diffusiondrive_torch.ops.stem_fused import fused_stem, stem_kernel, stem_plain

    kernels = {"stem": (fused_stem, stem_plain), "conv3x3": (fused_conv3x3, conv3x3_plain),
               "lap": (batched_linear_sum_assignment, linear_sum_assignment_plain)}
    rows = {}
    for key, calls in sorted(store.items(), key=lambda kv: str(kv[0])):
        kernel, shape, dtype_name, residual = key
        if kernel not in kernels:
            continue
        fn, plain = kernels[kernel]
        for i, (args, kwargs, _) in enumerate(calls):
            got, again, want = fn(*args, **kwargs), fn(*args, **kwargs), plain(*args, **kwargs)
            torch.cuda.synchronize()
            tag = f"{path} {kernel} {list(shape)} {dtype_name}{' residual' if residual else ''} call {i}"
            x = args[0]
            if kernel == "lap":
                if not torch.equal(got, want) or not torch.equal(got, again):
                    raise AssertionError(f"{tag}: the kernel's assignment differs from the plain version's")
                err, limit, ulps, kpath = 0.0, 0.0, None, "warp_redux"
                B, n, _ = shape
                flops, nbytes, bdtype = 0.0, 4.0 * B * n * n + 4.0 * B * n, torch.float32
                times = time_rows({"kernel_ms": lambda: fn(*args, **kwargs)})
                plain_t = time_rows({"plain_ms": lambda: plain(*args, **kwargs)}, iters=1, warmup=1)
                times["host_behind"] += plain_t.pop("host_behind")
                times.update(plain_t, library_ms=scipy_lap_ms(x))
            else:
                err, limit = check_close(tag, got, want, TOL[x.dtype])
                ulps = check_bf16_ulps(tag, got, want) if x.dtype == torch.bfloat16 else None
                if not torch.equal(got, again):
                    raise AssertionError(f"{tag}: two calls gave different bits")
                B, C, H, W = shape
                esize, bdtype = x.element_size(), x.dtype
                w, s, b = args[1:4]
                wf = (w.permute(3, 2, 0, 1).float() * s.float()[:, None, None, None]).to(x.dtype)
                bf = b.to(x.dtype)
                if kernel == "stem":
                    kpath = stem_kernel(x.dtype)
                    flops = 2.0 * B * (H // 2) * (W // 2) * 64 * 49 * C
                    nbytes = esize * (B * H * W * C + B * (H // 4) * (W // 4) * 64 + 49 * C * 64) + 2 * 64 * 4
                    lib = lambda: F.max_pool2d(  # noqa: E731
                        torch.relu_(F.conv2d(x, wf, bf, stride=2, padding=3)), 3, 2, 1)
                else:
                    kpath = conv3x3_kernel(x.dtype)
                    flops = 2.0 * B * H * W * 64 * 576
                    nbytes = esize * (B * H * W * 64 * (2 + residual) + 576 * 64) + 2 * 64 * 4
                    res = kwargs.get("residual", args[4] if len(args) > 4 else None)
                    if res is None:
                        lib = lambda: torch.relu_(F.conv2d(x, wf, bf, padding=1))  # noqa: E731
                    else:
                        lib = lambda: torch.relu_(F.conv2d(x, wf, bf, padding=1).add_(res))  # noqa: E731
                times = time_rows({"kernel_ms": lambda: fn(*args, **kwargs),
                                   "plain_ms": lambda: plain(*args, **kwargs), "library_ms": lib})
            bms, by = bound_ms(flops, nbytes, bdtype)
            row = dict(card=card, kernel=kernel, shape=list(shape), dtype=dtype_name, residual=residual,
                       path=kpath, max_abs_err=err, limit=limit, ulp_limit=ulps, same_bits_twice=True,
                       **times, bound_ms=bms, bound_by=by)
            log(f"{path} kernel {kernel} {list(shape)}{' residual' if residual else ''}", **row)
            rows[(kernel, shape, dtype_name, residual, i)] = row
    return rows


CAPABILITY_BATCH = 8   # the loop's defaults: batches of 8 (training and scoring)


def phase_capability_path(dev, card: str) -> tuple:
    """The closed train->eval loop (`script/run_capability_loop.py`) at its
    JAX defaults on the card: 40-frame synthetic logs at six speeds, the
    dryrun-size model (ResNet-18 x2, 64x256 camera, 64x64 BEV) trained in
    float32 for 30 epochs at B=8 (1 LAP a step), held-out metric caches by
    PDM-Closed, then the untrained and trained bf16 agents and human replay
    scored by the runner (2 stem and 8 conv3x3 a forward: ResNet-18's layer
    1). Requires `ok` (trained PDMS above untrained by more than 0.1) and
    each stage's launches as counted; logs PDMS, margin, stage walls. Each
    kernel the loop reaches is then held against its plain version on the
    inputs the loop gave it (`hold_recorded_kernels`). The splat is not on
    the loop's path: its feature builder bins the lidar on the host
    (`TransfuserFeatureBuilder`, the agent's default `preprocess_on_device=
    False`, as JAX's loop); it is held here at the loop's 64 bins
    (`pixels_per_meter=1`) on the held-out scenes' clouds, exact and the
    same bits twice. Returns (launches, kernel rows)."""
    from diffusiondrive_torch.common.dataclasses import CAMERA_NAMES, SceneFilter, SensorConfig
    from diffusiondrive_torch.common.dataloader import SceneLoader
    from diffusiondrive_torch.entry import recording_kernel_calls
    from diffusiondrive_torch.ops import kernel_counters
    from diffusiondrive_torch.ops.lidar_splat import _bin_indices, histogram2d, histogram2d_plain
    from diffusiondrive_torch.ops.preprocessing import pad_point_cloud
    from diffusiondrive_torch.script.run_capability_loop import HOLDOUT_SPEEDS, _tiny_config, run_capability_loop

    fns = kernel_counters()
    for f in fns.values():
        f.launches = 0
    phase_t0 = time.perf_counter()
    store: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capability_") as out:
        with recording_kernel_calls(store, keep=1):
            results = run_capability_loop(Path(out), batch_size=CAPABILITY_BATCH, device=dev)
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in fns.items()}
        cfg = _tiny_config()
        holdout = [f"speed_{s:.0f}" for s in HOLDOUT_SPEEDS]
        loader = SceneLoader(Path(out) / "data" / "logs", Path(out) / "data" / "blobs", SceneFilter(frame_interval=1),
                             SensorConfig(**{c: False for c in CAMERA_NAMES}, lidar_pc=[3]), build_map_api=False)
        tokens = [t for log_name, toks in loader.get_tokens_list_per_log().items() if log_name in holdout
                  for t in toks][:CAPABILITY_BATCH]
        clouds = [loader.get_agent_input_from_token(t).lidars[-1].lidar_pc for t in tokens]
    log("capability_path pdms", card=card, untrained=results["untrained_pdms"], trained=results["trained_pdms"],
        human_replay=results["human_replay_pdms"], margin=results["margin"], ok=results["ok"],
        train_tokens=results["num_train_tokens"], holdout_tokens=results["num_holdout_tokens"],
        epochs=results["num_epochs"], steps_per_epoch=results["steps_per_epoch"])
    log("capability_path stages", card=card, stage_s=results["stage_s"], launches_by_stage=results["launches"],
        wall_s=sum(results["stage_s"].values()))
    if not results["ok"]:
        raise AssertionError(f"capability_path: margin {results['margin']} <= 0.1: {results}")
    forwards = -(-results["num_holdout_tokens"] // CAPABILITY_BATCH)   # runner batches of one scoring run
    want = {"train": {"lap": results["num_epochs"] * results["steps_per_epoch"]},
            "evaluate_untrained": {"stem": 2 * forwards, "conv3x3": 8 * forwards},
            "evaluate_trained": {"stem": 2 * forwards, "conv3x3": 8 * forwards}}
    got = {stage: v for stage, v in results["launches"].items() if v}
    total = {k: sum(v.get(k, 0) for v in got.values()) for k in fns}
    if got != want or {k: v for k, v in counts.items() if v} != {k: v for k, v in total.items() if v}:
        raise AssertionError(f"capability_path: launches by stage {got}, want {want}; counters {counts}")

    rows = hold_recorded_kernels("capability_path", store, card)
    # the splat at the loop's 64 bins on its held-out clouds (B = the scoring batch)
    n = max(c.shape[1] for c in clouds)
    padded = [pad_point_cloud(c, n) for c in clouds]
    points = torch.from_numpy(np.stack([p for p, _ in padded])).to(dev)
    valid = torch.from_numpy(np.stack([v for _, v in padded])).to(dev)
    keep = valid & (points[..., 2] < cfg.max_height_lidar) & (points[..., 2] > cfg.lidar_split_height)
    bins = cfg.lidar_resolution_width
    ix, iy = _bin_indices(points[..., :2], keep, cfg.lidar_min_x, cfg.lidar_max_x, cfg.lidar_min_y,
                          cfg.lidar_max_y, bins)
    ix, iy = ix.contiguous(), iy.contiguous()
    got_h, again, want_h = histogram2d(ix, iy, bins), histogram2d(ix, iy, bins), histogram2d_plain(ix, iy, bins)
    torch.cuda.synchronize()
    err = (got_h - want_h).abs().max().item()
    if bins != 64 or err != 0 or not torch.equal(got_h, again):
        raise AssertionError(f"capability_path splat at {bins} bins: max abs err {err} (must be 0), "
                             f"repeatable {torch.equal(got_h, again)}")
    B = len(clouds)
    bms, by = bound_ms(0.0, 8.0 * B * n + 4.0 * B * bins * bins, torch.float32)
    row = dict(card=card, shape=[B, n], bins=bins, cloud="capability loop held-out scenes", path="segments",
               points_counted=int((ix >= 0).sum().item()), nonzero_bins=int((want_h > 0).sum().item()),
               max_abs_err=err, same_bits_twice=True,
               **time_rows({"kernel_ms": lambda: histogram2d(ix, iy, bins),
                            "plain_ms": lambda: histogram2d_plain(ix, iy, bins),
                            "library_ms": splat_library(ix, iy, bins)}),
               bound_ms=bms, bound_by=by, launches_on_path=counts["splat"])
    log("capability_path kernel lidar_splat bins64", **row)
    rows[("lidar_splat", "capability bins64", B)] = row
    log("capability_path launches", card=card, phase_s=time.perf_counter() - phase_t0,
        **{k: v for k, v in counts.items() if v})
    return {k: v for k, v in counts.items() if v}, rows


SOAK_STEPS = 200         # run_soak's default; the whole script may run fewer (PERF.md says so)
SOAK_EVERY = 50          # steps an epoch and a checkpoint
SOAK_STEPS_WHOLE = 150   # the soak's depth in the whole script: 3 epochs (PERF.md), 200 under --only soak_path


def phase_soak_path(dev, card: str, steps: int = SOAK_STEPS) -> tuple:
    """The sustained-training soak (`script/run_soak.py`) at full width on
    the card: B=8 bf16 steps with EMA 0.999 over a pool of 4 synthetic
    batches moved to the card once, a checkpoint every `SOAK_EVERY` steps
    (written under a temporary directory: each holds parameters, Adam and
    EMA state, ~1 GB). Requires `ok` (one `metrics.jsonl` row a step, the
    loss down, epochs 2..N within 35% of their median, each kernel counter
    rising by the same count every epoch, the CUDA kernels of an early and
    a late step equal, allocation at the end of epochs 2..N within 1 MB and
    their peaks within 1%, the last checkpoint restoring to `steps`) and 1
    LAP a step; logs the steady ms/step, epoch walls, loss windows, the
    kernels and host-to-device copies of a steady step, memory by epoch.
    Then the LAP is held against its plain version on the costs of the
    first step (`hold_recorded_kernels`). Returns (launches, kernel rows)."""
    from diffusiondrive_torch.entry import recording_kernel_calls
    from diffusiondrive_torch.ops import kernel_counters
    from diffusiondrive_torch.script.run_soak import run_soak

    fns = kernel_counters()
    for f in fns.values():
        f.launches = 0
    phase_t0 = time.perf_counter()
    store: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as out, recording_kernel_calls(store, keep=1):
        summary = run_soak(steps=steps, batch=8, pool=4, checkpoint_every=SOAK_EVERY, output_dir=out, device=dev)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in fns.items() if f.launches}
    log("soak_path run", card=card, steps=steps, ok=summary["ok"], failures=summary["failures"],
        steady_ms_per_step=summary["steady_ms_per_step"], epoch_walls_s=summary["epoch_walls_s"],
        epoch_walls_unprofiled_s=summary["epoch_walls_unprofiled_s"],
        wall_s=summary["wall_s"], loss_first_k=summary["loss_first_k"], loss_last_k=summary["loss_last_k"],
        loss_windows=summary["loss_windows"], steady_step_kernels=summary["compile_cache_size"],
        step_profiles=summary["step_profiles"], htod_copies_per_step=summary["htod_copies_per_step"],
        epoch_launches=summary["epoch_launches"],
        memory_end_gb=[b / 1e9 for b in summary["memory_end_bytes"]],
        memory_peak_gb=[b / 1e9 for b in summary["memory_peak_bytes"]], checkpoints=summary["checkpoints"])
    if not summary["ok"] or counts != {"lap": steps}:
        raise AssertionError(f"soak_path: failures {summary['failures']}, launches {counts} (want {steps} LAP)")
    rows = hold_recorded_kernels("soak_path", store, card)
    log("soak_path launches", card=card, phase_s=time.perf_counter() - phase_t0, **counts)
    return counts, rows


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


def scipy_lap_ms(c: torch.Tensor, iters: int = 10) -> float:
    """The LAP's yardstick in ms: scipy's `linear_sum_assignment` on the host
    over the batch of costs `c` on the card, with the device-to-host copy
    and the sync the reference pays every step."""
    from scipy.optimize import linear_sum_assignment

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        [linear_sum_assignment(x) for x in c.cpu().numpy()]
    return (time.perf_counter() - t0) / iters * 1e3


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

        library_ms = scipy_lap_ms(c)
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
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["ddp_path", "variants_path", "capability_path", "soak_path", "attention"],
                        help="run the device line, the build, cli_path and this phase only, and print no "
                             "kernels line (ddp_path over every visible card: NCCL ranks a card, device "
                             "lists of every card; variants_path: the registry's other model variants; "
                             "capability_path and soak_path run without cli_path, the soak at 200 steps; "
                             "attention: the attention kernel rows alone)")
    args = parser.parse_args()
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
    alone = {"capability_path": lambda: phase_capability_path(dev, card),
             "soak_path": lambda: phase_soak_path(dev, card), "attention": lambda: phase_attention(dev, build_logs)}
    if args.only in alone:
        alone[args.only]()
        log("chip_smoke wall", total_s=time.perf_counter() - _T0)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as cli_root:
            phase_cli_path(dev, card, Path(cli_root))
            {"ddp_path": phase_ddp_path, "variants_path": phase_variants_path}[args.only](dev, card, Path(cli_root))
        log("chip_smoke wall", total_s=time.perf_counter() - _T0)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    summary = phase_kernels(dev)
    summary.update(phase_attention(dev, build_logs))
    summary.update(phase_conv3x3_train(dev))
    summary.update(phase_lap(dev, build_logs))
    counts = {**phase_main_path(dev), "agent_path": phase_agent_path(dev),
              "pdm_score_path": phase_pdm_score_path(dev, card),
              "metric_caching_path": phase_metric_caching_path(dev, card), **phase_train_path(dev)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as cli_root:
        counts["cli_path"] = phase_cli_path(dev, card, Path(cli_root))
        counts["ddp_path"] = phase_ddp_path(dev, card, Path(cli_root))
        counts["variants_path"] = phase_variants_path(dev, card, Path(cli_root))
    counts["capability_path"], cap_rows = phase_capability_path(dev, card)
    counts["soak_path"], soak_rows = phase_soak_path(dev, card, SOAK_STEPS_WHOLE)
    summary.update({k: v for k, v in cap_rows.items() if k[0] == "lidar_splat"})

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
    f32 = torch.float32
    kernels[0]["rows"] = {label: {k: summary[("stem", label, bf)][k] for k in (
        "kernel_ms", "plain_ms", "bound_ms", "library_ms", "library_conv_ms", "path")} for label, _ in STEM_ROWS}
    kernels[1]["train_use"] = {f"{label} {part}": {k: summary[("conv3x3_train", label, part, bf)][k] for k in (
        "kernel_ms", "plain_ms", "bound_ms", "library_ms", "path")} for label in ("image", "lidar") for part in ("fwd", "dx")}
    # the float32 kernels (3xTF32 on the tensor cores): every row, eval and train use
    row_keys = ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path", "max_abs_err")
    kernels[0]["float32_rows"] = {label: {k: summary[("stem", label, f32)][k] for k in row_keys}
                                  for label, _ in STEM_ROWS}
    kernels[1]["float32_rows"] = {
        **{f"{label} {variant}": {k: summary[("conv3x3", label, variant, f32)][k] for k in row_keys}
           for label, _ in CONV_EVAL for variant in ("residual", "no_residual")},
        **{f"train {label} {part}": {k: summary[("conv3x3_train", label, part, f32)][k] for k in row_keys}
           for label, _ in CONV_TRAIN for part in ("fwd", "dx")}}
    kernels[2]["rows"] = {" ".join(map(str, k[1:])): {f: v[f] for f in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
                          for k, v in summary.items() if k[0] == "lidar_splat"}
    for entry in kernels[4:6]:   # ResNet-50's stage 3, beside the four ResNet-34 stages summed above
        entry["resnet50_d256"] = {f"{variant} {str(dt).split('.')[1]}": {
            f: summary[(entry["name"], 256, variant, dt)][f] for f in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend", "path", "max_abs_err",
                "regs_spills")}
            for variant in ("no_mask", "masked") for dt in (bf, torch.float32)}
    kernels[3]["rows"] = {f"b{k[1]}": {f: v[f] for f in ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                                                         "critical_steps", "ns_per_step")}
                          for k, v in summary.items() if k[0] == "lap"}
    for entry, kernel in ((kernels[0], "stem"), (kernels[1], "conv3x3"), (kernels[3], "lap")):
        # the new paths' rows: each kernel on the inputs capability_path and soak_path gave it
        rows = {f"{path} {list(k[1])} {k[2]}{' residual' if k[3] else ''}": {
            f: v[f] for f in ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "path")}
            for path, k, v in [(p, k, v) for p, part in (("capability_path", cap_rows), ("soak_path", soak_rows))
                               for k, v in part.items() if k[0] == kernel and k[4] == 0]}
        entry["path_rows"] = rows
        entry["max_abs_err"] = max([entry["max_abs_err"], *(r["max_abs_err"] for r in rows.values())])
    log("chip_smoke wall", total_s=time.perf_counter() - _T0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
