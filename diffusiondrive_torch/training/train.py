"""Training runtime: optimiser, train/validation/eval steps.

Counterpart of `diffusiondrive_tpu/training/train.py` on one device:

- AdamW (betas 0.9/0.999, eps 1e-8, weight decay on every parameter,
  BatchNorm and biases included, as `optax.adamw` with no mask) in two
  parameter groups, the image encoder at `image_encoder_lr_mult`, each
  following WarmupCosLR through `LambdaLR`; optional global-norm clipping
  with optax's formula ``g * c / max(|g|, c)``;
- `train_step`: the training forward, the loss (with the on-device
  Hungarian assignment), backward, the update and the EMA of the
  parameters, with no host round trip;
- `make_val_step`: the eval forward (the truncated 2-step DDIM rollout an
  evaluation runs) with the loss suite and ADE/FDE.

The JAX package's mesh becomes `DistributedDataParallel` (one process a
card, `training/trainer.py`): a state whose `ddp` is set runs its forward
through that wrapper, so the backward averages the gradients over the
ranks before the clip and the update, and the step's loss terms are
averaged over the ranks (one all-reduce, no host sync), as the JAX step
sharded over a mesh computes them on the global batch. Buffer donation has
no counterpart.

The step runs under profiler ranges "forward", "loss", "backward" and
"optimizer" ("lap" inside "loss"), which `script/run_profile.py --train`
reads; outside a profiler they cost a few microseconds a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR
from torch.profiler import record_function

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.parallel.distributed import all_reduce_mean
from diffusiondrive_torch.training.losses import transfuser_loss
from diffusiondrive_torch.training.scheduler import warmup_cos_lr

TARGET_KEYS = ("trajectory", "agent_states", "agent_labels", "bev_semantic_map")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 6e-4
    min_lr: float = 1e-6
    weight_decay: float = 1e-4
    epochs: int = 100
    warmup_epochs: int = 3
    steps_per_epoch: int = 1
    image_encoder_lr_mult: float = 0.5
    grad_clip_norm: Optional[float] = None
    ema_decay: Optional[float] = None  # e.g. 0.999


def param_label(name: str) -> str:
    """The LR group of a parameter: "image_encoder" when its name holds
    `image_encoder` (the JAX package's `_param_labels`), else "default"."""
    return "image_encoder" if "image_encoder" in name else "default"


def build_optimizer(opt_cfg: OptimizerConfig, model: nn.Module) -> Tuple[torch.optim.AdamW, LambdaLR]:
    """AdamW with one group per label and a LambdaLR that sets each group's
    rate to its WarmupCosLR value at the current step. The groups' base rate
    is 1, so the rate is the schedule's value exactly."""
    mults = {"default": 1.0, "image_encoder": opt_cfg.image_encoder_lr_mult}
    members: Dict[str, List[nn.Parameter]] = {label: [] for label in mults}
    for name, p in model.named_parameters():
        members[param_label(name)].append(p)
    groups, lambdas = [], []
    for label, params in members.items():
        if not params:
            continue
        m = mults[label]
        groups.append({"params": params, "lr": 1.0, "label": label})
        lambdas.append(warmup_cos_lr(opt_cfg.lr * m, opt_cfg.min_lr * m, opt_cfg.epochs,
                                     opt_cfg.warmup_epochs, opt_cfg.steps_per_epoch))
    optimizer = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=opt_cfg.weight_decay)
    return optimizer, LambdaLR(optimizer, lambdas)


def clip_by_global_norm_(params: List[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by ``c / max(|g|, c)`` (optax's
    `clip_by_global_norm`, no epsilon); returns the global norm. On the
    device: no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = max_norm / torch.clamp_min(norm, max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


@dataclasses.dataclass
class TrainState:
    """What a train step mutates: the model (parameters and BN statistics),
    the optimiser, its LR scheduler, the step and the EMA of the parameters
    (a deep copy, never an alias of them). `ddp`, when set, is the model
    wrapped in `DistributedDataParallel`, which the forward runs through;
    parameters, EMA and checkpoints are always those of `model`."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    scheduler: LambdaLR
    opt_cfg: OptimizerConfig
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ddp: Optional[nn.Module] = None


def create_train_state(model: nn.Module, opt_cfg: OptimizerConfig) -> TrainState:
    optimizer, scheduler = build_optimizer(opt_cfg, model)
    ema = None
    if opt_cfg.ema_decay is not None:
        ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model, optimizer, scheduler, opt_cfg, ema_params=ema)


def _targets(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: batch[k] for k in TARGET_KEYS}


def make_loss_fn(model: nn.Module, config: TransfuserConfig) -> Callable:
    """The train-path loss: the training forward (the model must be in train
    mode) and `transfuser_loss`. `timesteps` and `noise` fix the trajectory
    head's draws; otherwise they, and every dropout, come from `generator`.
    The UNet and MLP heads' single trajectory takes the L1 loss, as in JAX."""

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                timesteps: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        targets = _targets(batch)
        with record_function("forward"):
            outputs = model(batch["camera_feature"], batch["lidar_feature"], batch["status_feature"],
                            targets=targets, diffusion_noise=noise, generator=generator,
                            timesteps=timesteps)
        with record_function("loss"):
            loss_dict = transfuser_loss(targets, outputs, config)
        return loss_dict["loss"], loss_dict

    return loss_fn


def train_step(state: TrainState, config: TransfuserConfig, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, *,
               timesteps: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One step on device tensors: forward, loss, backward, AdamW update,
    LR schedule and EMA. Returns the loss terms as detached device scalars
    (reading them is the caller's sync). With `state.ddp` the gradients are
    averaged over the ranks inside the backward, before the clip, and the
    returned terms are the ranks' mean."""
    model = state.model
    net = state.ddp if state.ddp is not None else model
    net.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, loss_dict = make_loss_fn(net, config)(batch, generator, timesteps, noise)
    with record_function("backward"):
        loss.backward()
        # a parameter the forward did not use (`bev_proj` under the MLP and UNet
        # heads) has a zero gradient in JAX: AdamW then still decays it
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    with record_function("optimizer"):
        if state.opt_cfg.grad_clip_norm is not None:
            clip_by_global_norm_(list(model.parameters()), state.opt_cfg.grad_clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        decay = state.opt_cfg.ema_decay
        if decay is not None and state.ema_params is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    state.ema_params[name].mul_(decay).add_(p.detach(), alpha=1.0 - decay)
    state.step += 1
    out = {k: v.detach() for k, v in loss_dict.items()}
    return all_reduce_mean(out) if state.ddp is not None else out


def make_val_step(model: nn.Module, config: TransfuserConfig) -> Callable:
    """Validation on the eval forward (the truncated 2-step DDIM rollout an
    evaluation runs) with the loss suite and the open-loop ADE/FDE. `params`
    (name -> tensor, e.g. the EMA copy) replaces the model's parameters for
    the call; `noise` fixes the rollout's draw (else from `generator`)."""

    @torch.no_grad()
    def val_step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.eval()
        targets = _targets(batch)
        args = (batch["camera_feature"], batch["lidar_feature"], batch["status_feature"])
        kwargs = {"generator": generator, "diffusion_noise": noise}
        if params is None:
            outputs = model(*args, **kwargs)
        else:
            outputs = torch.func.functional_call(model, params, args, kwargs)
        metrics = dict(transfuser_loss(targets, outputs, config))
        l2 = torch.linalg.vector_norm(
            outputs["trajectory"][..., :2].float() - targets["trajectory"][..., :2], dim=-1)
        metrics["ade"] = l2.mean()
        metrics["fde"] = l2[:, -1].mean()
        return metrics

    return val_step


def make_eval_step(model: nn.Module) -> Callable:
    """The planner forward (test path) for batched evaluation."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.eval()
        return model(batch["camera_feature"], batch["lidar_feature"], batch["status_feature"],
                     generator=generator)

    return eval_step
