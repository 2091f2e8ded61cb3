"""What the per-layer metric files share: device time by host range, the
hand-written kernels' share of their roofline, the whole step's share of
the chip's peak."""

from __future__ import annotations

import sys
from typing import Optional, Sequence

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, TF32 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for `flops` operations and `nbytes`
    bytes in `dtype`: bf16 operations at the bf16 tensor-core rate; float32
    ones the faster of f32 FMAs and three TF32 products a product."""
    if dtype == "bfloat16":
        t_ops = flops / PEAK_BF16_FLOPS
    else:
        t_ops = min(flops / PEAK_F32_FLOPS, 3.0 * flops / PEAK_TF32_FLOPS)
    return max(t_ops, nbytes / PEAK_BYTES)


def range_ms(ctx, names: Sequence[str], minus: Sequence[str] = ()) -> Optional[float]:
    """Device ms a step of the operations launched inside `names`' ranges
    (less those inside `minus`'), or None where the trace has none."""
    t = ctx.trace
    ops = t.launched_in(names)
    if not ops:
        return None
    return (t.device_s(ops) - (t.device_s(t.launched_in(minus)) if minus else 0.0)) * 1e3 / t.steps


def launches(ctx) -> Optional[float]:
    n = len(ctx.trace.kernels)
    return n / ctx.trace.steps if n else None


def idle_share(ctx) -> Optional[float]:
    """The share of the timed window in which the device was idle, in %: the
    device's busy time a step, from the traced window's trace, against the
    timed window's time a step. The traced window's own wall time would
    count the profiler's host cost as idle."""
    busy = ctx.trace.busy_s()
    if busy <= 0:
        return None
    steps_per_s = ctx.rate / ctx.traffic["batch"]
    return 100.0 * (1.0 - busy / ctx.trace.steps * steps_per_s)


def mfu(ctx, key: str) -> Optional[float]:
    """The model's operations a sample (`key` of the configuration's counts)
    at the timed window's rate, as a share of the bf16 peak, in %."""
    return 100.0 * ctx.flops[key] * ctx.rate / PEAK_BF16_FLOPS


def kernel_roofline(ctx) -> Optional[float]:
    """The hand-written kernels' bound times over their device times in the
    traced window, in %. Every kernel file whose bounds apply to the cell
    has to find its kernels in the trace, and its wrapper's counter as many
    launches as the file expects: where one does not (a kernel renamed, left
    off the path, or launched another number of times), the sum would stand
    for other work, so the metric reads nothing, and says why on standard
    error."""
    bound = spent = 0.0
    dtype = ctx.cfg_dtype
    for k in ctx.kernel_files:
        per_step = k.launch_bounds(ctx.cfg, ctx.traffic, ctx.kind, dtype)
        if not per_step:
            continue
        ops = [o for o in ctx.trace.kernels if any(p in o.name for p in k.PATTERNS)]
        counted, expected = ctx.launches.get(k.COUNTER, 0), len(per_step) * ctx.trace.steps
        if not ops or counted != expected:
            print(f"kernel {k.COUNTER}: {len(ops)} launches of {k.PATTERNS} in the trace, {counted} counted, "
                  f"{expected} expected; no kernel roofline", file=sys.stderr)
            return None
        bound += sum(per_step) * ctx.trace.steps
        spent += sum(o.end - o.start for o in ops)
    return 100.0 * bound / spent if spent > 0 else None
