"""The reference's training objective and optimizer.

- `hungarian`: a NumPy Hungarian (shortest augmenting paths with
  potentials), the minimum-cost perfect matching of a square cost matrix;
- `loss`: DiffusionDrive's objective: per cascade layer the nearest-anchor
  mode, a sigmoid focal loss on the mode scores and L1 on that mode's poses;
  the Hungarian-matched agent loss (BCE on the labels, L1 on the boxes); the
  BEV-semantic cross-entropy; weighted as the configuration states;
- `AdamW`: decoupled weight decay on every parameter, betas 0.9 / 0.999,
  eps 1e-8, parameters whose name holds `image_encoder` at the image-encoder
  rate multiplier, each group's rate a linear warm-up then a cosine decay.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def hungarian(cost: np.ndarray) -> np.ndarray:
    """cols[i]: the column matched to row i in a minimum-cost perfect
    matching of the square float64 `cost`."""
    n = cost.shape[0]
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=np.int64)      # p[j]: row matched to column j (1-based, 0 = none)
    way = np.zeros(n + 1, dtype=np.int64)
    c = np.zeros((n + 1, n + 1))
    c[1:, 1:] = cost
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            free = ~used
            free[0] = False
            cur = c[i0] - u[i0] - v
            better = free & (cur < minv)
            minv[better] = cur[better]
            way[better] = j0
            cand = np.where(free, minv, INF)
            j1 = int(np.argmin(cand))
            delta = cand[j1]
            u[p[used]] += delta
            v[used] -= delta
            minv[free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    cols = np.zeros(n, dtype=np.int64)
    for j in range(1, n + 1):
        cols[p[j] - 1] = j - 1
    return cols


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.softplus(-logits) * labels + F.softplus(logits) * (1.0 - labels)


def focal(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * targets + p * (1.0 - targets)
    w = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * pt ** gamma
    return (bce_logits(logits, targets) * w).mean()


def loss(out: Dict[str, torch.Tensor], tgt: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """The weighted loss terms of a training forward's outputs `out`."""
    traj = tgt["trajectory"]
    anchors = out["plan_anchor"]
    mode = torch.linalg.vector_norm(traj[:, None, :, :2] - anchors, dim=-1).mean(-1).argmin(-1)
    rows = torch.arange(traj.shape[0], device=traj.device)
    traj_loss = 0.0
    for reg, cls in zip(out["poses_reg_layers"], out["poses_cls_layers"]):
        onehot = F.one_hot(mode, cls.shape[1]).to(cls.dtype)
        traj_loss = traj_loss + (cfg["trajectory_cls_weight"] * focal(cls, onehot)
                                 + cfg["trajectory_reg_weight"] * (reg[rows, mode] - traj).abs().mean())

    gt_states, gt_valid = tgt["agent_states"].float(), tgt["agent_labels"].float()
    pred, logits = out["agent_states"], out["agent_labels"]
    with torch.no_grad():
        cost = (cfg["agent_class_weight"] * bce_logits(logits[:, :, None], torch.ones_like(logits)[:, :, None])
                * gt_valid[:, None, :]
                + cfg["agent_class_weight"] * bce_logits(logits[:, :, None], torch.zeros_like(logits)[:, :, None])
                * (1.0 - gt_valid[:, None, :])
                + cfg["agent_box_weight"] * gt_valid[:, None, :]
                * (gt_states[:, None, :, :2] - pred[:, :, None, :2]).abs().sum(-1))
        c64 = cost.double().cpu().numpy()
        cols = torch.from_numpy(np.stack([hungarian(c) for c in c64])).to(pred.device)
    brow = rows[:, None]
    matched_states, matched_valid = gt_states[brow, cols], gt_valid[brow, cols]
    box = ((pred - matched_states).abs().sum(-1) * matched_valid).sum() / torch.clamp_min(gt_valid.sum(), 1.0)
    ce = bce_logits(logits, matched_valid).mean()

    sem = out["bev_semantic_map"]
    labels = tgt["bev_semantic_map"].long()
    bev = (torch.logsumexp(sem, dim=-1) - sem.gather(-1, labels[..., None])[..., 0]).mean()
    terms = {"trajectory_loss": cfg["trajectory_weight"] * traj_loss,
             "agent_class_loss": cfg["agent_class_weight"] * ce,
             "agent_box_loss": cfg["agent_box_weight"] * box,
             "bev_semantic_loss": cfg["bev_semantic_weight"] * bev}
    terms["loss"] = sum(terms.values())
    return terms


def lr_at(step: int, lr: float, min_lr: float, epochs: int, warmup: int, steps_per_epoch: int) -> float:
    """Linear warm-up over `warmup` epochs, then a cosine decay to `min_lr` by `epochs`."""
    w, total = warmup * steps_per_epoch, epochs * steps_per_epoch
    if step < w:
        return lr * (step + 1) / max(w, 1)
    progress = min(max((step - w) / max(total - w, 1), 0.0), 1.0)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * progress))


class AdamW:
    """AdamW over the leaves of `params` (name -> float32 tensor with grad)."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.params, self.opt = params, opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step_count = 0

    def lr(self, name: str) -> float:
        o = self.opt
        mult = o["image_encoder_lr_mult"] if "image_encoder" in name else 1.0
        return lr_at(self.step_count, o["lr"] * mult, o["min_lr"] * mult, o["epochs"], o["warmup_epochs"],
                     o["steps_per_epoch"])

    @torch.no_grad()
    def step(self) -> None:
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, self.opt["weight_decay"]
        t = self.step_count + 1
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            lr = self.lr(k)
            p.mul_(1.0 - lr * wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / (1.0 - b1 ** t))
        self.step_count = t

    def leaves(self) -> List[str]:
        return list(self.params)
