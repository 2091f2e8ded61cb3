"""Time one kernel family of this checkout against another checkout's, on one card.

Both checkouts' kernels keep one Python interface (`ops/attention_fused.py`,
`ops/conv_fused.py`, `ops/stem_fused.py`, `ops/hungarian.py`,
`ops/lidar_splat.py`), so one timing loop drives either. Each checkout runs
in a process of its own that imports its `diffusiondrive_torch` (built there
from its own sources), in the order ref, this, this, ref, so a drift of the
card over the call shows as a difference between the two runs of one
checkout. The inputs, the shapes and the timer are `chip_smoke.py`'s
(`time_rows`: each time the median of 3 repeats queued behind a spin
kernel, after one untimed pass over the first row). Every result is first
held against its own checkout's plain version (`chip_smoke.TOL`).

`--kernel attention` (the default; `phase_attention`): the fused attention
forward and backward at B=64, H=4, T=320, D = 16, 32, 64, 128, bf16 and
float32, without and with a p=0.1 keep mask. `--kernel conv3x3`
(`phase_kernels`, `phase_conv3x3_train`): the eval conv3x3 at B=16
(`CONV_EVAL`, with and without the residual, ReLU on) and the
`conv3x3_train` forward and input gradient at B=64 (`CONV_TRAIN`), bf16
and float32. `--kernel stem` (`phase_kernels`): the fused stem at
`STEM_ROWS` (camera and lidar at B=16, the camera at B=1), bf16 and
float32. `--kernel lap` (`phase_lap`): the LAP at n=30, B=8 and 64, on
`lap_costs` (half of each batch with ties); exact against the plain
version. `--kernel splat` (`phase_lidar_splat`): the splat at N=131072,
B=16 and 1, on `splat_inputs` (the agent path's example clouds and a
uniform cloud); exact against the plain version, the same bits twice.

Prints the card's name and power limit, then one JSON line per run: the
kernel ms of each row (attention: summed over D for each direction, dtype
and variant). `--out` gets one JSON line per run and row, with the three
repeats.

Example (one GPU; the parent commit unpacked into a gitignored directory):
    mkdir -p diffusiondrive_torch/_build/parent
    git archive HEAD~1 | tar -x -C diffusiondrive_torch/_build/parent
    python diffusiondrive_torch/script/run_kernel_ab.py --kernel conv3x3 \\
        --ref diffusiondrive_torch/_build/parent --out chiprun_out/conv3x3_ab.jsonl
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


def _timed_rows(smoke, cases) -> list:
    """`cases`: (row fields, {name: callable}) pairs; one row per callable,
    timed by `smoke.time_rows`, after one untimed pass over the first case."""
    rows = []
    for i, (fields, fns) in enumerate(cases):
        if i == 0:
            for fn in fns.values():
                smoke.queued_ms(fn, 10, 3)
        times = smoke.time_rows(fns)
        for part in fns:
            rows.append({**fields, "part": part, "ms": times[part], "runs": times[part + "_runs"],
                         "host_behind": part in times["host_behind"],
                         "key": " ".join(str(v) for k, v in fields.items() if k != "D") + f" {part}"})
    return rows


def attention_cases(smoke, dev, root: Path):
    import torch

    from diffusiondrive_torch.ops import attention_fused as af

    if not Path(af.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {af.__file__}, not the checkout at {root}")
    B, H, T = smoke.ATTN_BHT
    gen, mask_gen = torch.Generator().manual_seed(4), torch.Generator(device=dev)
    for D in smoke.ATTN_D:
        base = [torch.randn(B, T, H, D, generator=gen) for _ in range(4)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (t.to(dev, dtype).transpose(1, 2) for t in base)
            for pdrop in (0.0, 0.1):
                mask = af.dropout_keep_mask(mask_gen.manual_seed(D), (B, H, T, T), pdrop, dev) if pdrop else None
                fns = {"fwd": lambda: af.fused_attention(q, k, v, mask, pdrop),
                       "bwd": lambda: af.fused_attention_bwd(q, k, v, mask, do, pdrop)}
                variant = "masked" if pdrop else "no_mask"
                tag = f"D={D} {variant} {dtype}"
                smoke.check_close(f"attention_fwd {tag}", fns["fwd"](),
                                  af.attention_fwd_plain(q, k, v, mask, pdrop), smoke.TOL[dtype])
                for name, g, w in zip(("dq", "dk", "dv"), fns["bwd"](),
                                      af.attention_bwd_plain(q, k, v, mask, do, pdrop)):
                    smoke.check_close(f"attention_bwd {name} {tag}", g, w, smoke.TOL[dtype])
                yield {"dtype": str(dtype).replace("torch.", ""), "variant": variant, "D": D}, fns


def conv3x3_cases(smoke, dev, root: Path):
    import torch

    from diffusiondrive_torch.ops import conv_fused as cf

    if not Path(cf.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cf.__file__}, not the checkout at {root}")
    gen = torch.Generator().manual_seed(0)
    s = (torch.rand(64, generator=gen) + 0.5).to(dev)
    b = (torch.randn(64, generator=gen) * 0.1).to(dev)
    one, zero = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    for label, shape in smoke.CONV_EVAL:
        w_oihw = torch.randn(64, 64, 3, 3, generator=gen) / 24.0
        for dtype in (torch.bfloat16, torch.float32):
            x, r = (smoke.nhwc_randn(shape, gen, dev, dtype) for _ in range(2))
            w = cf.to_hwio(w_oihw.to(dev), dtype)
            for res in (None, r):
                variant = "residual" if res is not None else "no_residual"
                fn = lambda: cf.fused_conv3x3(x, w, s, b, res, relu=True)  # noqa: E731
                smoke.check_close(f"conv3x3 {label} {variant} {dtype}", fn(),
                                  cf.conv3x3_plain(x, w, s, b, res, relu=True), smoke.TOL[dtype])
                yield {"dtype": str(dtype).replace("torch.", ""), "row": f"conv3x3 {label} {variant}"}, {"kernel": fn}
    for label, shape in smoke.CONV_TRAIN:
        w_oihw = torch.randn(64, 64, 3, 3, generator=gen) / 24.0
        for dtype in (torch.bfloat16, torch.float32):
            x, g = (smoke.nhwc_randn(shape, gen, dev, dtype) for _ in range(2))
            w = cf.to_hwio(w_oihw.to(dev), dtype)
            w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
            for part, fn, plain in (
                    ("fwd", lambda: cf.conv3x3_train(x, w), lambda: cf.conv3x3_train_plain(x, w)),
                    ("dx", lambda: cf.fused_conv3x3(g, w_flip, one, zero),
                     lambda: cf.conv3x3_plain(g, w_flip, one, zero))):
                smoke.check_close(f"conv3x3_train {label} {part} {dtype}", fn(), plain(), smoke.TOL[dtype])
                yield {"dtype": str(dtype).replace("torch.", ""), "row": f"conv3x3_train {label} {part}"}, {"kernel": fn}


def stem_cases(smoke, dev, root: Path):
    import torch

    from diffusiondrive_torch.ops import conv_fused as cf
    from diffusiondrive_torch.ops import stem_fused as sf

    if not Path(sf.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {sf.__file__}, not the checkout at {root}")
    gen = torch.Generator().manual_seed(0)
    s = (torch.rand(64, generator=gen) + 0.5).to(dev)
    b = (torch.randn(64, generator=gen) * 0.1).to(dev)
    for label, shape in smoke.STEM_ROWS:
        w_oihw = torch.randn(64, shape[3], 7, 7, generator=gen) / (49 * shape[3]) ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            x = smoke.nhwc_randn(shape, gen, dev, dtype)
            w = cf.to_hwio(w_oihw.to(dev), dtype)
            fn = lambda: sf.fused_stem(x, w, s, b)  # noqa: E731
            smoke.check_close(f"stem {label} {dtype}", fn(), sf.stem_plain(x, w, s, b), smoke.TOL[dtype])
            yield {"dtype": str(dtype).replace("torch.", ""), "row": f"stem {label}"}, {"kernel": fn}


def lap_cases(smoke, dev, root: Path):
    import torch

    from diffusiondrive_torch.ops import hungarian as hg

    if not Path(hg.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {hg.__file__}, not the checkout at {root}")
    for B, costs in smoke.lap_costs().items():
        c = torch.from_numpy(costs).to(dev)
        if not torch.equal(hg.batched_linear_sum_assignment(c), hg.linear_sum_assignment_plain(c)):
            raise AssertionError(f"lap B={B}: kernel assignment differs from the plain version's")
        yield {"row": f"lap b{B}"}, {"kernel": lambda: hg.batched_linear_sum_assignment(c)}


def splat_cases(smoke, dev, root: Path):
    import torch

    from diffusiondrive_torch.ops import lidar_splat as ls

    if not Path(ls.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ls.__file__}, not the checkout at {root}")
    bins = smoke.SPLAT_BINS
    for kind, (ix, iy) in smoke.splat_inputs(dev).items():
        for B in (16, 1):
            bx, by = ix[:B].contiguous(), iy[:B].contiguous()
            got, again = ls.histogram2d(bx, by, bins), ls.histogram2d(bx, by, bins)
            if not (torch.equal(got, ls.histogram2d_plain(bx, by, bins)) and torch.equal(got, again)):
                raise AssertionError(f"lidar_splat {kind} B={B}: not exact, or not the same bits twice")
            yield {"row": f"lidar_splat {kind} b{B}"}, {"kernel": lambda: ls.histogram2d(bx, by, bins)}


KERNELS = {"attention": attention_cases, "conv3x3": conv3x3_cases, "stem": stem_cases,
           "lap": lap_cases, "splat": splat_cases}


def worker(root: Path, kernel: str) -> list:
    """Time the `kernel` family of the checkout at `root`; one dict a row."""
    sys.path.insert(0, str(root))
    import torch

    torch.backends.cudnn.allow_tf32 = False  # as `chip_smoke.main`: float32 plain versions in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _chip_smoke()
    return _timed_rows(smoke, KERNELS[kernel](smoke, torch.device("cuda", 0), root))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", type=Path, help="root of the other checkout")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="attention")
    ap.add_argument("--out", type=Path, help="JSON lines, one per timed row")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve(), args.kernel)), flush=True)
        return 0
    if args.ref is None:
        ap.error("--ref is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    out = args.out.open("w") if args.out else None
    for run, (tree, root) in enumerate((("ref", args.ref), ("this", ROOT), ("this", ROOT), ("ref", args.ref))):
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root), "--kernel", args.kernel],
                              stdout=subprocess.PIPE, text=True, check=True)
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        sums = {}
        for r in rows:
            sums[r["key"]] = sums.get(r["key"], 0.0) + r["ms"]
            if out:
                out.write(json.dumps({"run": run, "tree": tree, **r}) + "\n")
        print(json.dumps({"run": run, "tree": tree, "root": str(root), "kernel_ms": sums,
                          "host_behind": [r["key"] for r in rows if r["host_behind"]]}), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
