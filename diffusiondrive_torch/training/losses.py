"""Training losses (counterpart of `diffusiondrive_tpu/training/losses.py`).

- diffusion trajectory loss: per cascade layer, nearest-anchor mode
  assignment, sigmoid focal loss on the mode classification, L1 on the best
  mode's poses;
- the global loss: weighted sum of the trajectory loss, the Hungarian-matched
  detection loss (BCE + L1) and the BEV-semantic cross-entropy.

The detection loss's assignment is `ops/hungarian.py` on the loss's own
device, on the detached float32 cost: kernel B4 on the card for n <= 31,
with no host round trip; above that, as JAX takes its XLA solver, the plain
solver on the card, whose loops read their exit condition on the host.
Nothing else here synchronises with the host.

Under a process group of more than one rank (data-parallel training) the
box loss's normaliser, the count of valid agents, is summed over the
group, and each rank's term is scaled by the world size: the mean of the
ranks' terms is then the global batch's. Every other term is a mean over
rows of equal size on every rank, so the ranks' mean of it is already the
global batch's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.layers import stat_dtype
from diffusiondrive_torch.ops.hungarian import MAX_N, batched_linear_sum_assignment, linear_sum_assignment_plain
from diffusiondrive_torch.ops.sampling import take_rows
from diffusiondrive_torch.parallel.distributed import world_size


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Element-wise BCE with logits, optax's formula."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Element-wise sigmoid focal loss, mean-reduced."""
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * targets + p * (1.0 - targets)
    focal_weight = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * pt ** gamma
    return (sigmoid_binary_cross_entropy(logits, targets) * focal_weight).mean()


def single_layer_trajectory_loss(poses_reg: torch.Tensor, poses_cls: torch.Tensor,
                                 target_traj: torch.Tensor, plan_anchor: torch.Tensor,
                                 config: TransfuserConfig) -> torch.Tensor:
    """One cascade layer's loss. poses_reg (B, M, P, 3), poses_cls (B, M),
    target_traj (B, P, 3), plan_anchor (B, M, P, 2)."""
    M = poses_cls.shape[1]
    dist = torch.linalg.vector_norm(target_traj[:, None, :, :2] - plan_anchor, dim=-1).mean(-1)
    mode_idx = dist.argmin(dim=-1)  # (B,)
    # one-hot by comparison: F.one_hot checks its indices on the host
    onehot = (mode_idx[:, None] == torch.arange(M, device=mode_idx.device)).to(poses_cls.dtype)
    loss_cls = config.trajectory_cls_weight * sigmoid_focal_loss(poses_cls, onehot)
    best_reg = take_rows(poses_reg, mode_idx[:, None])[:, 0]
    loss_reg = config.trajectory_reg_weight * (best_reg - target_traj).abs().mean()
    return loss_cls + loss_reg


def diffusion_trajectory_loss(predictions: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                              config: TransfuserConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Summed per-layer cascade loss and each layer's term."""
    regs = predictions["poses_reg_layers"]   # (L, B, M, P, 3)
    clss = predictions["poses_cls_layers"]   # (L, B, M)
    anchors = predictions["plan_anchor"]     # (B, M, P, 2)
    total = 0.0
    loss_dict = {}
    for layer in range(regs.shape[0]):
        layer_loss = single_layer_trajectory_loss(regs[layer], clss[layer], targets["trajectory"],
                                                  anchors, config)
        loss_dict[f"trajectory_loss_{layer}"] = layer_loss
        total = total + layer_loss
    return total, loss_dict


def _ce_cost(gt_valid: torch.Tensor, pred_logits: torch.Tensor) -> torch.Tensor:
    """(B, n_pred, n_gt) BCE-with-logits cost."""
    gt = gt_valid[:, None, :].float()
    logits = pred_logits[:, :, None]
    max_val = F.relu(-logits)
    helper = max_val + torch.log(torch.exp(-max_val) + torch.exp(-logits - max_val))
    return (1.0 - gt) * logits + helper


def _l1_cost(gt_states: torch.Tensor, pred_states: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """(B, n_pred, n_gt) centre-distance cost."""
    diff = (gt_states[:, None, :, :2] - pred_states[:, :, None, :2]).abs().sum(-1)
    return gt_valid[:, None, :].float() * diff


def agent_detection_loss(targets: Dict[str, torch.Tensor], predictions: Dict[str, torch.Tensor],
                         config: TransfuserConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hungarian-matched detection loss: (BCE on the labels, L1 on the boxes)."""
    gt_states = targets["agent_states"].float()   # (B, N, 5)
    gt_valid = targets["agent_labels"].float()    # (B, N)
    pred_states = predictions["agent_states"]     # (B, N, 5)
    pred_logits = predictions["agent_labels"]     # (B, N)
    world = world_size()
    if world > 1:
        # the batch's count of valid agents is global under data
        # parallelism, as under JAX's mesh; no host sync on the card
        count = gt_valid.sum().detach()
        dist.all_reduce(count)
        num_gt = torch.clamp_min(count, 1.0)
    else:
        num_gt = torch.clamp_min(gt_valid.sum(), 1.0)

    cost = (config.agent_class_weight * _ce_cost(gt_valid, pred_logits)
            + config.agent_box_weight * _l1_cost(gt_states, pred_states, gt_valid))
    # cols[b, i] = the gt index matched to prediction i; no gradient flows
    # through the assignment. As JAX's `_lsa_local`: the kernel for the sizes
    # it takes, the plain solver on the cost's own device otherwise.
    cost = cost.detach().float().contiguous()
    solve = batched_linear_sum_assignment if 1 <= cost.shape[-1] <= MAX_N else linear_sum_assignment_plain
    with record_function("lap"):
        cols = solve(cost).long()

    gt_states_m = take_rows(gt_states, cols)
    gt_valid_m = take_rows(gt_valid, cols)
    l1 = (pred_states - gt_states_m).abs().sum(-1) * gt_valid_m
    # a rank's term is scaled by the world size, so that the ranks' mean
    # (DDP averages gradients, the trainer the reported terms) is the
    # global sum over the global count
    l1_loss = l1.sum() / num_gt if world == 1 else l1.sum() * world / num_gt
    ce_loss = sigmoid_binary_cross_entropy(pred_logits, gt_valid_m).mean()
    return ce_loss, l1_loss


def bev_semantic_loss(predictions: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross-entropy over the (B, H, W, C) class-last semantic map."""
    logits = predictions["bev_semantic_map"]
    logits = logits.to(stat_dtype(logits))
    labels = targets["bev_semantic_map"].long()
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def transfuser_loss(targets: Dict[str, torch.Tensor], predictions: Dict[str, torch.Tensor],
                    config: TransfuserConfig) -> Dict[str, torch.Tensor]:
    """The combined loss dict. Floating predictions are upcast to float32 on
    entry (float64 ones stay float64): under bf16 compute the log/exp/focal
    terms and the sums must run in float32 or small components round away."""
    predictions = {k: v.to(stat_dtype(v)) if v.is_floating_point() else v for k, v in predictions.items()}
    if "poses_reg_layers" in predictions:
        trajectory_loss, traj_dict = diffusion_trajectory_loss(predictions, targets, config)
    else:  # the eval forward's single trajectory (the validation step)
        trajectory_loss = (predictions["trajectory"] - targets["trajectory"]).abs().mean()
        traj_dict = {}

    agent_class_loss, agent_box_loss = agent_detection_loss(targets, predictions, config)
    bev_loss = bev_semantic_loss(predictions, targets)
    loss = (config.trajectory_weight * trajectory_loss
            + config.agent_class_weight * agent_class_loss
            + config.agent_box_weight * agent_box_loss
            + config.bev_semantic_weight * bev_loss)
    loss_dict = {
        "loss": loss,
        "trajectory_loss": config.trajectory_weight * trajectory_loss,
        "agent_class_loss": config.agent_class_weight * agent_class_loss,
        "agent_box_loss": config.agent_box_weight * agent_box_loss,
        "bev_semantic_loss": config.bev_semantic_weight * bev_loss,
    }
    loss_dict.update(traj_dict)
    return loss_dict
