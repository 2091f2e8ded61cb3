#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It drives
`diffusiondrive_torch` only (never JAX or the JAX package) and prints one
line per phase, then one JSON line per kernel summary, then the result:

1. ``device``  the card's name and power limit (nvidia-smi).
2. ``build``   builds every CUDA kernel from `diffusiondrive_torch/csrc/`
               with nvcc for sm_90a (one nvcc per source, in parallel) into
               `diffusiondrive_torch/_build/`; prints seconds and ptxas stats.
3. ``kernel``  each kernel at the planner's shapes (B=16), in bf16 and f32,
               against its plain PyTorch version (max abs error and the
               tolerance), timed with CUDA events beside the plain version,
               a cuDNN yardstick (`library_ms`, never used by the port) and
               the card's bound for the same work (`bound_ms`).
4. ``main_path`` the full-width planner forward (default TransfuserConfig,
               seeded random weights): (a) float32 at B=1 on the card against
               the same model on the CPU; (b) bf16 at B=1 and B=16, finite
               outputs and frames/s. The kernel launch counters are set to 0
               before this phase and must read 2 stem and 12 conv3x3 launches
               per forward after it.
5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Any failure raises and exits non-zero; without a CUDA device it exits 2
before printing any result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
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


def phase_build() -> None:
    from diffusiondrive_torch.ops import _build

    t0 = time.time()
    logs = _build.build_all()
    stats = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.time() - t0, 3), built=sorted(logs), ptxas=stats[:24])


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
    phase_build()
    summary = phase_kernels(dev)
    counts = phase_main_path(dev)

    bf = torch.bfloat16
    kernels = []
    for name, row, src, replaces, errs in (
        ("stem_fused", summary[("stem", "camera", bf)], "diffusiondrive_torch/csrc/stem_fused.cu",
         "diffusiondrive_tpu/ops/stem_fused.py:95",
         [summary[("stem", lbl, bf)]["max_abs_err"] for lbl in ("camera", "lidar")]),
        ("conv3x3_fused", summary[("conv3x3", "image", "residual", bf)],
         "diffusiondrive_torch/csrc/conv3x3_fused.cu", "diffusiondrive_tpu/ops/conv_fused.py:55",
         [v["max_abs_err"] for k, v in summary.items() if k[0] == "conv3x3" and k[-1] == bf]),
    ):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts["stem" if name == "stem_fused" else "conv3x3"],
                        "max_abs_err": max(errs), "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "pass": True})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
