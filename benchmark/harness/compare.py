"""The numbers that decide `correct`, each compared with its limit.

Training: the first steps of the window's own call against the reference's
steps from the same weights, batches and draws. A cell's limits file
(`benchmark/limits/<cell>.json`) names the numbers it compares:

- `poses_err`, `bev_err`: the first step's training-forward outputs (every
  cascade layer's poses; the BEV semantic logits), as the relative L2
  distance to the reference's;
- `grad_gap`: the worst parameter's gap between the program's and the
  reference's first-step gradient norms, over the larger of the
  reference's norm of that parameter and of the median parameter;
- `change_gap`: the same of the parameters' change over the checked steps,
  leaving out parameters whose reference gradient is under a thousandth of
  the median parameter's (they move under Adam by round-off alone);
- read and not compared: `grad_err`, the median parameter's distance
  between the two first gradients, and `loss_gap`, the first step's
  relative loss gap (neither tells bf16 from float8: PERF.md).

Evaluation: every trajectory the window brought to the host, against the
reference's forward on the same raw sensors and noise:

- `repeat_gap`: the widest gap between two answers to the same input;
- `traj_gap`: the widest gap (m) between a served trajectory and the
  reference's poses of the mode the program chose;
- `choice_gap`: the widest gap by which the reference's score of the
  program's chosen mode lies below the reference's best score;
- `reg_gap` and `cls_gap`: the widest gaps of every mode's poses (m) and
  scores.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

EVAL_NUMBERS = ("repeat_gap", "traj_gap", "choice_gap", "reg_gap", "cls_gap")
GRAD_FLOOR = 1e-3   # of the median parameter's reference gradient norm


def leaf_gaps(got: Mapping[str, float], want: Mapping[str, float], names: Sequence[str]) -> np.ndarray:
    """Each parameter's gap of norms over the larger of its reference norm and the median parameter's."""
    med = float(np.median([want[k] for k in names]))
    return np.array([abs(got[k] - want[k]) / max(want[k], med) for k in names])


def grad_errors(grads: Mapping[str, torch.Tensor], ref_grads: Mapping[str, torch.Tensor],
                names: Sequence[str]) -> np.ndarray:
    """Each parameter's distance between the program's and the reference's
    first gradients, over the larger of its reference norm and the median
    parameter's."""
    norms = {k: float(torch.linalg.vector_norm(ref_grads[k])) for k in names}
    med = float(np.median(list(norms.values())))
    return np.array([float(torch.linalg.vector_norm(grads[k].float() - ref_grads[k])) / max(norms[k], med)
                     for k in names])


def train_numbers(losses: Sequence[float], outputs: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                  change_norms: Mapping[str, float], ref: Mapping) -> Dict[str, float]:
    """The training numbers of the program's readings against the
    reference's (`reference.train`); a cell's limits file names those it
    compares, the others are kept for `calibrate.py`."""
    if set(grads) != set(ref["grad_norms"]) or len(losses) != len(ref["losses"]):
        raise ValueError("the program's parameters or steps differ from the reference's")
    names = sorted(ref["grad_norms"])
    med = float(np.median([ref["grad_norms"][k] for k in names]))
    moving = [k for k in names if ref["grad_norms"][k] >= GRAD_FLOOR * med]
    B = outputs["agent_labels"].shape[0]          # the rows the program saw

    def rel(key: str) -> float:
        want = ref["outputs"][key]
        want = want[:, :B] if key.endswith("_layers") else want[:B]
        return float(torch.linalg.vector_norm(outputs[key] - want) / torch.linalg.vector_norm(want))

    grad_norms = {k: float(torch.linalg.vector_norm(grads[k].float())) for k in names}
    return {"poses_err": rel("poses_reg_layers"), "bev_err": rel("bev_semantic_map"),
            "grad_gap": float(leaf_gaps(grad_norms, ref["grad_norms"], names).max()),
            "change_gap": float(leaf_gaps(change_norms, ref["change_norms"], moving).max()),
            # read for the record, compared in no cell (PERF.md gives why)
            "grad_err": float(np.median(grad_errors(grads, ref["grads"], names))),
            "loss_gap": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0])}


def eval_numbers(served: Sequence[List[np.ndarray]], kept: Sequence[Mapping[str, torch.Tensor]],
                 ref: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, float]:
    """`served[i]`: every trajectory the window fetched for input batch i;
    `kept[i]`: the program's last outputs on batch i (poses and scores);
    `ref[i]`: the reference's on batch i."""
    out = {k: 0.0 for k in EVAL_NUMBERS}
    if not any(served):
        return {k: float("nan") for k in EVAL_NUMBERS}
    for answers, prog, want in zip(served, kept, ref):
        if not answers:            # an input the window did not reach
            continue
        first = answers[0]
        out["repeat_gap"] = max(out["repeat_gap"], max(float(np.abs(a - first).max()) for a in answers))
        reg, cls = prog["poses_reg"].float(), prog["poses_cls"].float()
        wreg, wcls = want["poses_reg"].to(reg.device), want["poses_cls"].to(reg.device)
        choice = cls.argmax(-1)
        rows = torch.arange(len(choice), device=reg.device)
        traj = torch.from_numpy(np.stack(answers)).to(reg.device)           # (n, B, P, 3)
        out["traj_gap"] = max(out["traj_gap"], float((traj - wreg[rows, choice][None]).abs().max()))
        out["choice_gap"] = max(out["choice_gap"], float((wcls.max(-1).values - wcls[rows, choice]).max()))
        out["reg_gap"] = max(out["reg_gap"], float((reg - wreg).abs().max()))
        out["cls_gap"] = max(out["cls_gap"], float((cls - wcls).abs().max()))
    return out


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number over its limit, or not finite, fails."""
    return {k: {"value": numbers[k], "limit": limits[k],
                "ok": bool(np.isfinite(numbers[k]) and numbers[k] <= limits[k])} for k in limits}
