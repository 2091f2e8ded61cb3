"""Time the fused attention kernels of this checkout against another checkout's, on one card.

Both checkouts' `csrc/attention_fused.cu` keep one C interface, so one
timing loop drives either. Each checkout runs in a process of its own that
imports its `diffusiondrive_torch` (built there from its own sources), in
the order ref, this, this, ref, so a drift of the card over the call shows
as a difference between the two runs of one checkout. The inputs, the
shapes and the timer are `chip_smoke.py`'s (`phase_attention`,
`time_rows`): B=64, H=4, T=320, D = 16, 32, 64, 128, bf16 and float32,
without and with a p=0.1 keep mask, each time the median of 3 repeats
queued behind a spin kernel, after one untimed pass over the first row.
Every result is first held against its plain version (`chip_smoke.TOL`).

Prints the card's name and power limit, then one JSON line per run: the
forward and backward kernel ms summed over D for each dtype and variant.
`--out` gets one JSON line per run, direction, D, dtype and variant, with
the three repeats.

Example (one GPU; the parent commit unpacked into a gitignored directory):
    mkdir -p diffusiondrive_torch/_build/parent
    git archive HEAD~1 | tar -x -C diffusiondrive_torch/_build/parent
    python diffusiondrive_torch/script/run_attention_ab.py \\
        --ref diffusiondrive_torch/_build/parent --out chiprun_out/attention_ab.jsonl
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    """This checkout's `chip_smoke.py`, for its shapes, tolerances and timer."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: Path) -> list:
    """Time the attention kernels of the checkout at `root`; one dict a row."""
    sys.path.insert(0, str(root))
    import torch

    from diffusiondrive_torch.ops import attention_fused as af

    if not Path(af.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {af.__file__}, not the checkout at {root}")
    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    B, H, T = smoke.ATTN_BHT
    gen, mask_gen = torch.Generator().manual_seed(4), torch.Generator(device=dev)
    rows, warm = [], False
    for D in smoke.ATTN_D:
        base = [torch.randn(B, T, H, D, generator=gen) for _ in range(4)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (t.to(dev, dtype).transpose(1, 2) for t in base)
            for pdrop in (0.0, 0.1):
                mask = af.dropout_keep_mask(mask_gen.manual_seed(D), (B, H, T, T), pdrop, dev) if pdrop else None
                fns = {"fwd": lambda: af.fused_attention(q, k, v, mask, pdrop),
                       "bwd": lambda: af.fused_attention_bwd(q, k, v, mask, do, pdrop)}
                tag = f"D={D} {'masked' if pdrop else 'no_mask'} {dtype}"
                smoke.check_close(f"attention_fwd {tag}", fns["fwd"](),
                                  af.attention_fwd_plain(q, k, v, mask, pdrop), smoke.TOL[dtype])
                for name, g, w in zip(("dq", "dk", "dv"), fns["bwd"](),
                                      af.attention_bwd_plain(q, k, v, mask, do, pdrop)):
                    smoke.check_close(f"attention_bwd {name} {tag}", g, w, smoke.TOL[dtype])
                if not warm:
                    for fn in fns.values():
                        smoke.queued_ms(fn, 10, 3)
                    warm = True
                times = smoke.time_rows(fns)
                for part in ("fwd", "bwd"):
                    rows.append({"part": part, "D": D, "dtype": str(dtype), "variant": "masked" if pdrop else "no_mask",
                                 "ms": times[part], "runs": times[part + "_runs"],
                                 "host_behind": part in times["host_behind"]})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", type=Path, help="root of the other checkout")
    ap.add_argument("--out", type=Path, help="JSON lines, one per timed row")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    if args.ref is None:
        ap.error("--ref is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    out = args.out.open("w") if args.out else None
    for run, (tree, root) in enumerate((("ref", args.ref), ("this", ROOT), ("this", ROOT), ("ref", args.ref))):
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root)], stdout=subprocess.PIPE,
                              text=True, check=True)
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        sums = {}
        for r in rows:
            key = f"{r['part']} {r['dtype'].replace('torch.', '')} {r['variant']}"
            sums[key] = sums.get(key, 0.0) + r["ms"]
            if out:
                out.write(json.dumps({"run": run, "tree": tree, **r}) + "\n")
        print(json.dumps({"run": run, "tree": tree, "root": str(root), "summed_over_D_ms": sums,
                          "host_behind": [f"{r['part']} {r['D']} {r['dtype']} {r['variant']}"
                                          for r in rows if r["host_behind"]]}), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
