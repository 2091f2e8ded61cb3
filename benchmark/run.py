"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or `python -m benchmark.run ...` from the repository's root). The cell,
its configuration, traffic and limits are found by name from
`BENCHMARK.json`. With `--trace 0` the result carries the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, read from a short window
under the profiler after the timed one. The numbers that decide `correct`
are printed beside their limits as the last lines on standard error and
last in the result's line.
"""

from __future__ import annotations

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness.env import forbidden_modules, prepare  # noqa: E402

prepare()


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them (empty if it cannot)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def per_layer(cell, ctx) -> dict:
    """Each per-layer metric's reader over the traced window; one that finds nothing is left out."""
    out, readers = {}, cell.readers()
    for m in cell.per_layer:
        value = readers[m["name"]].read(ctx)
        if value is None:
            print(f"per-layer metric {m['name']}: nothing to read", file=sys.stderr)
        else:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness.cells import KINDS
    from benchmark.harness.compare import judge
    from benchmark.harness.manifest import Cell, kernel_specs

    cell = Cell(args.workload)
    cell.clock0 = CLOCK0
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    result = KINDS[cell.traffic["kind"]](cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3

    checks = judge(result["numbers"], cell.limits)
    correct = all(c["ok"] for c in checks.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(result["peak"]), "nvidia_smi": power_limit()}
    line = {"correct": correct, "attempted": int(result["attempted"]), "failed": 0}
    if args.trace:
        ctx = result["ctx"]
        ctx.kernel_files = kernel_specs()
        line["metrics"] = per_layer(cell, ctx)
        device.update(busy_s=ctx.trace.busy_s(), window_s=ctx.trace.window_s)
        line["breakdown"] = ctx.trace.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        line["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in result["metrics"].items()}
    line["device"] = device
    line["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
