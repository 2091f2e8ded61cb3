"""Rank functions for `test_torch_port_parallel.py`'s spawned process groups.

A spawned rank imports this module by name, so it holds only what a rank
runs and imports neither JAX nor the test modules.
"""

from pathlib import Path

import numpy as np
import torch

from diffusiondrive_torch.entry import build_model, place_targets_at_predictions
from diffusiondrive_torch.models.layers import disable_dropout
from diffusiondrive_torch.parallel.distributed import rank, world_size
from diffusiondrive_torch.parallel.mesh import rank_rows
from diffusiondrive_torch.training.train import OptimizerConfig
from diffusiondrive_torch.training.trainer import Trainer

LR = 1e-3          # SGD, as JAX's mesh-equivalence test
PERTURB = 0.05     # parameter perturbation scale, as JAX's test
CLIP = 5000.0      # global-norm clip; the test step's unclipped norm is ~12500
EMA = 0.9


def comparison_model(cfg, dtype=torch.float32, head="diffusion"):
    """The seeded model with the `head` trajectory head, its parameters
    perturbed by N(0, 0.05) (JAX's test), dropout off;
    `dtype=torch.float64` computes in float64."""
    from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel

    model = build_model(cfg, seed=0, trajectory_head_type=head)
    gen = torch.Generator().manual_seed(42)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(PERTURB * torch.randn(p.shape, generator=gen))
    if dtype == torch.float64:
        m64 = DiffusionDriveModel(cfg, head, dtype=torch.float64)
        m64.load_state_dict(model.state_dict())
        model = m64.to(torch.float64)
    disable_dropout(model)
    return model


def placed_batch(cfg, batch, head="diffusion"):
    """`batch` with the agent targets at the model's own predictions for
    the trainer's step-0 draws (a unique detection assignment)."""
    model = comparison_model(cfg, head=head).train()
    trainer = Trainer(model, cfg, OptimizerConfig(), seed=0)
    timesteps, noise = model.trajectory_head.train_draws(len(batch["status_feature"]), trainer.step_generator(0))
    with torch.no_grad():
        pred = model(*(torch.from_numpy(batch[k]) for k in ("camera_feature", "lidar_feature", "status_feature")),
                     targets={"trajectory": torch.from_numpy(batch["trajectory"])}, timesteps=timesteps,
                     diffusion_noise=noise)["agent_states"].numpy()
    return place_targets_at_predictions(batch, pred, np.random.default_rng(0))


SAMPLES = 512      # elements of each tensor kept for comparisons across processes


def digest(tensors):
    """Per tensor: a hash of its bytes (bit identity across ranks)."""
    import hashlib

    return {k: hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, t in tensors.items()}


def sample(tensors):
    """Per tensor: `SAMPLES` evenly spaced elements, in float64."""
    out = {}
    for k, t in tensors.items():
        flat = t.detach().reshape(-1).double().cpu()
        out[k] = flat[::max(1, flat.numel() // SAMPLES)][:SAMPLES]
    return out


def sgd_step(cfg, batch, device, dtype=torch.float32, head="diffusion"):
    """One `Trainer` step with SGD (lr 1e-3), the clip and the EMA on this
    rank's rows of the global `batch`. Returns the loss terms, the BN
    running statistics, samples, norms and digests of the parameters and
    gradients after the step, and the EMA's digest."""
    model = comparison_model(cfg, dtype, head).to(device)
    trainer = Trainer(model, cfg, OptimizerConfig(grad_clip_norm=CLIP, ema_decay=EMA), seed=0)
    trainer.setup()
    trainer.state.optimizer = torch.optim.SGD(model.parameters(), lr=LR)
    trainer.state.scheduler = torch.optim.lr_scheduler.LambdaLR(trainer.state.optimizer, lambda step: 1.0)
    rows = rank_rows(len(batch["status_feature"]), rank(), world_size())
    trainer.fit(lambda epoch: [{k: v[rows] for k, v in batch.items()}], 1)
    params = dict(model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    return {"metrics": trainer.last_train_metrics,
            "stats": {k: b.detach().double().cpu() for k, b in model.named_buffers() if "running" in k},
            "params": sample(params), "grads": sample(grads),
            "grad_norms": {k: g.double().norm().item() for k, g in grads.items()},
            "digest": {"params": digest(params), "grads": digest(grads), "ema": digest(trainer.state.ema_params)}}


def adamw_step(cfg, batch, device, dtype=torch.float32, head="diffusion"):
    """One `Trainer` step with the default AdamW on this rank's rows of the
    global `batch`. Returns the loss terms, the BN running statistics,
    samples, norms and digests of the parameters and gradients after the
    step, and the `bev_proj` parameters before and after it."""
    model = comparison_model(cfg, dtype, head).to(device)
    before = {k: p.detach().cpu().clone() for k, p in model.named_parameters() if k.startswith("bev_proj.")}
    trainer = Trainer(model, cfg, OptimizerConfig(), seed=0)
    rows = rank_rows(len(batch["status_feature"]), rank(), world_size())
    trainer.fit(lambda epoch: [{k: v[rows] for k, v in batch.items()}], 1)
    params = dict(model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    return {"metrics": trainer.last_train_metrics,
            "stats": {k: b.detach().double().cpu() for k, b in model.named_buffers() if "running" in k},
            "params": sample(params), "grads": sample(grads),
            "grad_norms": {k: g.double().norm().item() for k, g in grads.items()},
            "digest": {"params": digest(params), "grads": digest(grads)},
            "bev_proj_before": before, "bev_proj": {k: params[k].detach().cpu() for k in before}}


def fit_with_checkpoint(cfg, samples, device, out_dir):
    """`Trainer.fit` (AdamW, dropout live) for one epoch over `samples` in
    global batches of 2, this rank's rows, with validation and a
    checkpoint; returns the digest of the parameters after it, the steps,
    the epoch's terms, the validation metrics and the first draws of this
    rank's dropout stream."""
    from diffusiondrive_torch.training.dataset import batch_iterator

    model = build_model(cfg, seed=0).to(device)
    trainer = Trainer(model, cfg, OptimizerConfig(epochs=2, warmup_epochs=1, steps_per_epoch=2),
                      output_dir=str(out_dir), seed=4)
    trainer.fit(lambda epoch: batch_iterator(samples, 2, shuffle=True, seed=epoch, num_workers=1,
                                             rank=rank(), world_size=world_size()), 1,
                val_batches=lambda epoch: batch_iterator(samples, 2, shuffle=False, num_workers=1,
                                                         rank=rank(), world_size=world_size()))
    return {"params": digest(dict(model.named_parameters())), "steps": trainer.state.step,
            "train": trainer.last_train_metrics, "val": trainer.last_val_metrics,
            "dropout_draw": torch.rand(4, generator=trainer.rank_generator(0)).tolist()}


def head_rank(rank_, world, device, cfg, batch, dtype, head):
    """A rank of the MLP and UNet heads' DDP test: the AdamW step."""
    return adamw_step(cfg, batch, device, dtype, head)


def step_rank(rank_, world, device, cfg, batch, dtype):
    """A rank of the card's DDP test: the SGD step and its LAP launches."""
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment

    lap0 = batched_linear_sum_assignment.launches
    out = sgd_step(cfg, batch, device, dtype)
    return {**out, "lap": batched_linear_sum_assignment.launches - lap0}


def ddp_rank(rank_, world, device, cfg, batch, samples, out_dir, dtype=torch.float32):
    """A rank of the DDP test: the SGD step, then `Trainer.fit` with a
    checkpoint under `out_dir`."""
    return {"step": sgd_step(cfg, batch, device, dtype),
            "fit": fit_with_checkpoint(cfg, samples, device, Path(out_dir) / "fit")}


def fail_on_rank_one(rank_, world, device):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank_ == 1:
        raise ValueError("rank one fails")
    torch.distributed.barrier()

