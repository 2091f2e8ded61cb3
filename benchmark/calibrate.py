"""Readings that the correctness limits of `benchmark/limits/` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... [--controls 4]

For each seed, in one process: the cell's weights and inputs, then the
program's outputs through the timed path's own call (training: the first
steps through `Trainer.fit`; evaluation: `predict` on each input batch),
compared with the float32 reference. On the first `--controls` seeds also
the float8 control (the reference one precision below the configuration's
bfloat16) and, for training, the program fed half of each batch. One JSON
line a seed and reading on standard output: the numbers of
`harness/compare.py`, and for training the parameters that set the
worst-leaf gaps. The runs' own cells never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness.env import prepare  # noqa: E402

prepare()


def worst(got, want, names, k=3):
    """The `k` parameters with the widest gaps: [name, gap, program's norm, reference's]."""
    from benchmark.harness.compare import leaf_gaps

    gaps = leaf_gaps(got, want, names)
    return [[names[i], float(gaps[i]), got[names[i]], want[names[i]]] for i in gaps.argsort()[::-1][:k]]


def train_seed(cell, agent, seed, device, control: bool):
    import numpy as np
    import torch

    from benchmark.harness import cells, compare, data, program
    from benchmark.harness.weights import make_weights

    doc, tr = cell.config_doc, cell.traffic
    cfg = doc["as_run"]
    specs = program.weight_specs(agent.model)
    pool = data.training_pool(cfg, {**tr, "pool_batches": cells.CHECKED_STEPS}, seed, device)
    out = []

    def program_run(batches, label):
        weights = make_weights(specs, seed, cfg["num_poses"], device)
        agent.model.load_state_dict(weights)
        start = {n: v.detach().cpu() for n, v in weights.items()}
        del weights
        trainer, opt = program.make_trainer(agent, doc["optimizer"], seed)
        readings = cells.checked_steps(trainer, agent.model, start, batches)
        del trainer
        cells._free()
        return start, opt, readings

    t = time.perf_counter()
    start, opt, (losses, outs, grads, change) = program_run(pool, "program")
    ref = cells.reference_train(start, cfg, opt, pool, seed, device, "float32")
    names = sorted(ref["grad_norms"])
    med = float(np.median([ref["grad_norms"][n] for n in names]))
    moving = [n for n in names if ref["grad_norms"][n] >= compare.GRAD_FLOOR * med]

    def row(label, l_, o_, g_, c_):
        gn = {n: float(torch.linalg.vector_norm(g_[n].float())) for n in names}
        return {"seed": seed, "reading": label, **compare.train_numbers(l_, o_, g_, c_, ref),
                "loss_gaps": [abs(a - b) / abs(b) for a, b in zip(l_, ref["losses"])],
                "losses": l_, "ref_losses": ref["losses"], "worst_grad": worst(gn, ref["grad_norms"], names),
                "worst_change": worst(c_, ref["change_norms"], moving)}

    out.append(row("program", losses, outs, grads, change))
    if control:
        for prec in ("float8", "bfloat16"):
            ctl = cells.reference_train(start, cfg, opt, pool, seed, device, prec)
            label = "control_float8" if prec == "float8" else "reference_bfloat16"
            out.append(row(label, ctl["losses"], ctl["outputs"], ctl["grads"], ctl["change_norms"]))
        half = [{n: v[: tr["batch"] // 2] for n, v in b.items()} for b in pool]
        _, _, (hl, ho, hg, hc) = program_run(half, "half_batch")
        out.append(row("fault_half_batch", hl, ho, hg, hc))
    torch.cuda.empty_cache()
    for r in out:
        r["seconds"] = time.perf_counter() - t
    return out


def agent_seed(cell, agent, seed, device, control: bool):
    import torch

    from benchmark import reference
    from benchmark.harness import compare, data, program
    from benchmark.harness.weights import make_weights
    from benchmark.reference.precision import Precision

    doc, tr = cell.config_doc, cell.traffic
    cfg = doc["as_run"]
    t = time.perf_counter()
    weights = make_weights(program.weight_specs(agent.model), seed, cfg["num_poses"], device)
    agent.model.load_state_dict(weights)
    batches = data.sensor_batches(cfg, tr, seed, device)
    served, kept = [], []
    for inputs, noise in batches:
        answers = []
        for _ in range(2):
            out = agent.predict(inputs, diffusion_noise=noise)
            answers.append(out["trajectory"].float().cpu().numpy())
        served.append(answers)
        kept.append({"poses_reg": out["poses_reg"], "poses_cls": out["poses_cls"]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = [reference.predict(weights, cfg, b, n, Precision("float32")) for b, n in batches]
    rows = [{"seed": seed, "reading": "program", **compare.eval_numbers(served, kept, ref)}]
    if control:
        ctl = [reference.predict(weights, cfg, b, n, Precision("float8")) for b, n in batches]
        rows.append({"seed": seed, "reading": "control_float8", **compare.eval_numbers(
            [[c["trajectory"].cpu().numpy()] for c in ctl], ctl, ref)})
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    del batches, kept, ref
    torch.cuda.empty_cache()
    for r in rows:
        r["seconds"] = time.perf_counter() - t
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3, help="seeds that also read the control and the faults")
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import program
    from benchmark.harness.manifest import Cell

    cell = Cell(args.workload)
    device = torch.device("cuda:0")
    kind = cell.traffic["kind"]
    agent = program.build_agent(cell.config_doc, device, preprocess_on_device=kind == "agent")
    run = train_seed if kind == "train" else agent_seed
    for i, seed in enumerate(args.seeds):
        for r in run(cell, agent, seed, device, i < args.controls):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
