"""Planner-forward profile on the card: where one forward's time goes.

Builds the full-width bf16 planner (`entry.py`, seeded random weights), runs
3 warm-up forwards, then `FORWARDS` forwards under `torch.profiler`, and
prints JSON lines: host wall ms per forward, device busy ms per forward (the union of
kernel intervals) and the device's idle share, kernel launches and
host-to-device copies per forward; for each model component (module paths
up to depth `DEPTH`, inclusive of their children) its device busy ms, kernel
launches and host ms per forward; and the `TOP` kernels by device time.
The range hooks and the profiler add host time, so the wall time here is
above an unprofiled forward's. Needs a CUDA device; there is no CPU fallback.

Example (one GPU):
    python -m diffusiondrive_torch.script.run_profile --batch 16 --trace trace.json
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

FORWARDS = 5
DEPTH = 2      # module-path depth of the components
TOP = 15       # kernels to list


def _annotate(model: torch.nn.Module, depth: int) -> list:
    """Wrap each module at path depth <= `depth` in a profiler range named by its path."""
    names = []
    for name, module in model.named_modules():
        if not name or name.count(".") >= depth:
            continue
        ranges = []

        def pre(_m, _a, name=name, ranges=ranges):
            ranges.append(record_function(name))
            ranges[-1].__enter__()

        def post(_m, _a, _o, ranges=ranges):
            ranges.pop().__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)
        names.append(name)
    return names


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = parser.parse_args()

    from diffusiondrive_torch.entry import entry

    if not torch.cuda.is_available():
        raise SystemExit("run_profile: no CUDA device")
    model, inputs = entry(dtype=torch.bfloat16, batch=args.batch)
    components = _annotate(model, DEPTH)
    gen = torch.Generator(device=inputs["status_feature"].device)
    n = FORWARDS
    with torch.no_grad():
        for _ in range(3):
            model(**inputs, generator=gen.manual_seed(0))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(**inputs, generator=gen.manual_seed(0))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    if args.trace:
        prof.export_chrome_trace(args.trace)

    events = prof.events()
    names = set(components)
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    # the component ranges show on the device timeline too: they are no kernels
    kernels = [e for e in on_device if e.name not in names
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    htod = [e for e in on_device if "htod" in e.name.lower()]
    spans = lambda evs: [(e.time_range.start, e.time_range.end) for e in evs]  # noqa: E731
    busy_ms = _busy_us(spans(kernels)) / 1e3 / n
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.elapsed_us()
        by_kernel[e.name][1] += 1
    # a component's device time: the kernels inside its range on the device timeline
    by_component = defaultdict(lambda: [0.0, 0, 0.0])
    for e in on_device:
        if e.name in names:
            inside = [k for k in kernels if e.time_range.start <= k.time_range.start < e.time_range.end]
            by_component[e.name][0] += _busy_us(spans(inside)) / 1e3 / n
            by_component[e.name][1] += len(inside) / n
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in names:
            by_component[e.name][2] += e.time_range.elapsed_us() / 1e3 / n

    print(json.dumps({"device": torch.cuda.get_device_name(0), "dtype": "bfloat16", "batch": args.batch,
                      "forwards": n, "wall_ms_per_forward": wall_ms,
                      "device_busy_ms_per_forward": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / wall_ms,
                      "kernel_launches_per_forward": len(kernels) / n,
                      "htod_copies_per_forward": len(htod) / n}))
    print(json.dumps({"components": [
        {"name": k, "device_ms": v[0], "launches": v[1], "host_ms": v[2]}
        for k, v in sorted(by_component.items(), key=lambda kv: -kv[1][0])]}))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({"top_kernels": [{"name": k[:120], "ms_per_forward": v[0] / 1e3 / n,
                                        "launches_per_forward": v[1] / n} for k, v in top]}))


if __name__ == "__main__":
    main()
