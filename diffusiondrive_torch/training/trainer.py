"""Training orchestration: epochs, logging, checkpoints.

Counterpart of `diffusiondrive_tpu/training/trainer.py`. The per-step work
is `train.train_step`; this class runs the host loop: batch iteration and
the copy to the device, the deferred metric fetch, callback hooks, a
per-step `metrics.jsonl`, validation (of the EMA weights too) and
checkpoints.

Where the JAX trainer shards each batch over a device mesh, this one runs
in each process of a `torch.distributed` group (one a card; `torchrun` or
`parallel/distributed.py:launch`): when a group is initialized the model
is wrapped in `DistributedDataParallel`, each rank is given its rows of
every global batch (`training/dataset.py:batch_iterator(rank=,
world_size=)`), the trajectory head's draws are made for the global batch
and sliced (its `train_draws` and `draw_noise`: the diffusion and UNet
heads'; the MLP head draws nothing), validation metrics are
averaged over the ranks, and rank 0 alone writes metrics and checkpoints,
from the unwrapped model. Without a group nothing of this runs.

Each step's draws (the diffusion timesteps and noise, every dropout mask)
come from one generator on the device, seeded from (`seed + 1`, step), as
the JAX trainer folds the step into its key: a resumed run draws what the
uninterrupted run would have, with no saved generator state. Under a
group the timesteps and noise come from that generator for the global
batch, and the dropout masks from one seeded from (`seed + 1`, step,
rank), so that the ranks' masks differ.

A checkpoint is a directory ``epoch_<NNNN>`` holding ``state.pt``
(`torch.save`) with what the JAX package's orbax checkpoint holds: params,
BN statistics, constants, optimiser state, step and EMA params, plus the
LR scheduler and the number of finished epochs.
"""

from __future__ import annotations

import inspect
import json
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.parallel.distributed import all_reduce_mean
from diffusiondrive_torch.parallel.mesh import rank_rows
from diffusiondrive_torch.training.train import (
    OptimizerConfig,
    TrainState,
    create_train_state,
    make_eval_step,
    make_val_step,
    train_step,
)

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = "state.pt"
Batches = Callable[[int], Iterable[Dict[str, np.ndarray]]]


def split_state_dict(model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model's tensors in the JAX package's collections: "params" (the
    parameters), "constants" (the plan anchors) and "batch_stats" (every
    other buffer: the BN running statistics)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    out: Dict[str, Dict[str, torch.Tensor]] = {"params": params, "batch_stats": {}, "constants": {}}
    for k, v in model.state_dict().items():
        if k not in params:
            out["constants" if k.endswith("plan_anchor") else "batch_stats"][k] = v
    return out


def checkpoint_state_dict(payload: Mapping, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """A full `state_dict` from a checkpoint's payload; `use_ema` takes the
    EMA parameters (and raises if the checkpoint has none)."""
    params = payload.get("ema_params") if use_ema else payload["params"]
    if params is None:
        raise ValueError("use_ema=True but the checkpoint has no ema_params")
    return {**params, **payload["batch_stats"], **payload["constants"]}


def load_checkpoint(path: Union[str, Path], device: torch.device) -> Dict:
    """Read ``<path>/state.pt`` (a checkpoint directory of `Trainer`)."""
    return torch.load(Path(path) / CHECKPOINT_FILE, map_location=device, weights_only=True)


class Trainer:
    """The train loop on the model's device; data-parallel over the ranks of
    the default process group when one is initialized."""

    def __init__(self, model: nn.Module, model_config: TransfuserConfig, opt_cfg: OptimizerConfig,
                 output_dir: Optional[str] = None, seed: int = 0, callbacks: Optional[List] = None):
        self.device = next(model.parameters()).device
        self.model = model
        self.model_config = model_config
        self.opt_cfg = opt_cfg
        self.output_dir = Path(output_dir) if output_dir else None
        self.seed = seed
        self.callbacks = list(callbacks or [])
        self.state: Optional[TrainState] = None
        self.epochs_done = 0
        self.last_val_metrics: Dict[str, float] = {}
        self.last_train_metrics: Dict[str, float] = {}
        self._val_fn = make_val_step(self.model, model_config)
        self._eval_fn = make_eval_step(self.model)
        self._generator = torch.Generator(device=self.device)
        self._metrics_fp = None
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank, self.world_size = (dist.get_rank(), dist.get_world_size()) if self.distributed else (0, 1)
        if self.distributed:
            self._rank_generator = torch.Generator(device=self.device)

    def _hook(self, name: str, *args, **kwargs) -> None:
        """Invoke `name` on every callback that implements it; a callback's
        failure is logged with its traceback and does not stop training."""
        for cb in self.callbacks:
            fn = getattr(cb, name, None)
            if fn is not None:
                try:
                    fn(*args, **kwargs)
                except Exception:  # noqa: BLE001 — a callback must not kill training
                    logger.exception("callback %s.%s failed", type(cb).__name__, name)

    def _log_metrics(self, split: str, epoch: int, step: int, metrics: Dict[str, float]) -> None:
        """Append one row to `<output_dir>/metrics.jsonl`."""
        if self.output_dir is None or self.rank != 0:
            return
        if self._metrics_fp is None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            self._metrics_fp = open(self.output_dir / "metrics.jsonl", "a")
        row = {"split": split, "epoch": epoch, "step": step,
               **{k: round(float(v), 6) for k, v in metrics.items()}}
        self._metrics_fp.write(json.dumps(row) + "\n")
        self._metrics_fp.flush()

    def setup(self) -> None:
        """Create the optimiser state (and the EMA copy) for the model; under
        a process group, wrap the model in `DistributedDataParallel` (which
        copies rank 0's parameters and buffers to every rank)."""
        self.state = create_train_state(self.model, self.opt_cfg)
        if self.distributed:
            from torch.nn.parallel import DistributedDataParallel

            cuda = self.device.type == "cuda"
            # BN statistics are global (`models/layers.py`), so the buffers
            # agree on every rank without DDP's per-forward broadcast (the
            # wrapper still copies rank 0's at construction)
            no_sync = ({"forward_sync_buffers": False}
                       if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
                       else {"broadcast_buffers": False})
            # the MLP and UNet heads leave `bev_proj` unused in every step
            unused = getattr(self.model, "trajectory_head_type", "diffusion") != "diffusion"
            self.state.ddp = DistributedDataParallel(self.model, device_ids=[self.device.index] if cuda else None,
                                                     find_unused_parameters=unused, **no_sync)

    def step_generator(self, step: int) -> torch.Generator:
        """The device generator re-seeded for `step` from (seed + 1, step)."""
        seed = np.random.SeedSequence([self.seed + 1, step]).generate_state(1, np.uint64)[0]
        return self._generator.manual_seed(int(seed))

    def rank_generator(self, step: int) -> torch.Generator:
        """Under a process group: the dropout generator of this rank at
        `step`, seeded from (seed + 1, step, rank)."""
        seed = np.random.SeedSequence([self.seed + 1, step, self.rank]).generate_state(1, np.uint64)[0]
        return self._rank_generator.manual_seed(int(seed))

    def global_draws(self, step: int, rows: int):
        """Under a process group: (timesteps, noise) of this rank's `rows`,
        drawn from `step_generator(step)` for the global batch of
        `rows * world_size` rows, as one device would draw them."""
        total = rows * self.world_size
        timesteps, noise = self.model.trajectory_head.train_draws(total, self.step_generator(step))
        mine = rank_rows(total, self.rank, self.world_size)
        return tuple(None if t is None else t[mine] for t in (timesteps, noise))

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy batch on the trainer's device. On CUDA the arrays are
        pinned first, so the copies run asynchronously on the stream. A
        tensor already on the device passes through (a batch moved there
        once and cycled, as `script/run_soak.py` does)."""
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor) and v.device == self.device:
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if cuda else t).to(self.device, non_blocking=cuda)
        return out

    @staticmethod
    def _fetch(rows: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
        """Device scalars -> floats in one copy (one sync)."""
        if not rows or not rows[0]:
            return [{} for _ in rows]
        keys = list(rows[0])
        vals = torch.stack([torch.stack([r[k].float() for k in keys]) for r in rows]).cpu().tolist()
        return [dict(zip(keys, v)) for v in vals]

    def fit(self, train_batches: Batches, num_epochs: int, val_batches: Optional[Batches] = None,
            log_every: int = 50, checkpoint_every_epochs: int = 1,
            validate_every_epochs: int = 1) -> TrainState:
        """Train until `num_epochs` epochs are done in all (a restored run
        continues from its checkpoint's epoch)."""
        try:
            return self._fit(train_batches, num_epochs, val_batches, log_every,
                             checkpoint_every_epochs, validate_every_epochs)
        finally:
            if self._metrics_fp is not None:
                self._metrics_fp.close()
                self._metrics_fp = None

    def _fit(self, train_batches, num_epochs, val_batches, log_every, checkpoint_every_epochs,
             validate_every_epochs) -> TrainState:
        for epoch in range(self.epochs_done, num_epochs):
            self._hook("on_epoch_start", "train", epoch)
            epoch_start = time.perf_counter()
            metrics_acc: Dict[str, float] = {}
            count = 0
            # Deferred metric fetch: reading a loss blocks until its step is
            # done, so the steps are enqueued back to back and the device
            # scalars are read every `log_every` steps and at the epoch's end;
            # every step still gets its own row.
            pending: List = []

            def flush_pending() -> Dict[str, float]:
                rows = self._fetch([m for _, m in pending])
                for (gstep, _), row in zip(pending, rows):
                    self._log_metrics("train", epoch, gstep, row)
                    for k, v in row.items():
                        metrics_acc[k] = metrics_acc.get(k, 0.0) + v
                pending.clear()
                return rows[-1] if rows else {}

            for batch in train_batches(epoch):
                if self.state is None:
                    self.setup()
                tensors = self.to_device(batch)
                if self.state.ddp is None:
                    metrics = train_step(self.state, self.model_config, tensors,
                                         self.step_generator(self.state.step))
                else:
                    step = self.state.step
                    timesteps, noise = self.global_draws(step, len(tensors["status_feature"]))
                    metrics = train_step(self.state, self.model_config, tensors, self.rank_generator(step),
                                         timesteps=timesteps, noise=noise)
                count += 1
                pending.append((self.state.step, metrics))
                if count % log_every == 0:
                    logger.info("epoch %d step %d: %s", epoch, count,
                                {k: round(v, 4) for k, v in flush_pending().items()})
            flush_pending()
            means = {k: v / max(count, 1) for k, v in metrics_acc.items()}
            self.last_train_metrics = means
            logger.info("epoch %d done in %.1fs (%d steps): train %s", epoch,
                        time.perf_counter() - epoch_start, count,
                        {k: round(v, 4) for k, v in means.items()})
            self.epochs_done = epoch + 1
            self._hook("on_epoch_end", "train", epoch)

            if val_batches is not None and (epoch + 1) % validate_every_epochs == 0:
                self._hook("on_epoch_start", "val", epoch)
                self._validate(val_batches(epoch), epoch)
                self._hook("on_epoch_end", "val", epoch)
            if self.output_dir and (epoch + 1) % checkpoint_every_epochs == 0:
                self.save_checkpoint(epoch)
        return self.state

    def _validate(self, batches: Iterable[Dict[str, np.ndarray]], epoch: int) -> Dict[str, float]:
        """Validation on the eval forward, with a fixed noise draw (the
        generator re-seeded to 0 for every batch); with EMA on, the EMA
        weights are validated too, under `ema_` names. The first batch also
        feeds any `on_validation_batch` callback with the eval outputs (on
        rank 0). Under a process group each rank validates its rows and the
        metrics are averaged over the ranks, as JAX's `shard_val_step`
        computes them on the global batch."""
        if self.state is None:
            self.setup()
        wants_outputs = self.rank == 0 and any(getattr(cb, "on_validation_batch", None) for cb in self.callbacks)
        variants = [("", None)]
        if self.state.ema_params is not None:
            variants.append(("ema_", self.state.ema_params))
        totals: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in batches:
            tensors = self.to_device(batch)
            noise = None
            if self.distributed:   # the noise of the global batch, this rank's rows (as one device draws it)
                rows = len(tensors["status_feature"])
                noise = self.model.trajectory_head.draw_noise(rows * self.world_size, self._generator.manual_seed(0))
                if noise is not None:
                    noise = noise[rank_rows(rows * self.world_size, self.rank, self.world_size)]
            for prefix, params in variants:
                metrics = self._val_fn(tensors, self._generator.manual_seed(0), params, noise)
                for k, v in metrics.items():
                    totals[prefix + k] = totals.get(prefix + k, 0.0) + v
            if count == 0 and wants_outputs:
                outputs = self._eval_fn(tensors, self._generator.manual_seed(0))
                outputs = {k: v.float().cpu().numpy() for k, v in outputs.items()}
                self._hook("on_validation_batch", epoch, batch, outputs, 0)
            count += 1
        if self.distributed:
            totals = all_reduce_mean(totals)
        fetched = self._fetch([totals])
        means = {k: v / max(count, 1) for k, v in (fetched[0] if fetched else {}).items()}
        self.last_val_metrics = means
        self._log_metrics("val", epoch, self.state.step, means)
        logger.info("epoch %d val: %s", epoch, {k: round(v, 4) for k, v in means.items()})
        return means

    def save_checkpoint(self, epoch: int) -> Path:
        """Write ``epoch_<NNNN>/state.pt`` from the unwrapped model (no
        ``module.`` prefix); under a process group rank 0 writes it and
        every rank waits for it at a barrier."""
        path = (self.output_dir / f"epoch_{epoch:04d}").absolute()
        if self.rank == 0:
            path.mkdir(parents=True, exist_ok=True)
            payload = {**split_state_dict(self.model),
                       "opt_state": self.state.optimizer.state_dict(),
                       "scheduler": self.state.scheduler.state_dict(),
                       "step": self.state.step, "epoch": self.epochs_done}
            if self.state.ema_params is not None:
                payload["ema_params"] = self.state.ema_params
            torch.save(payload, path / CHECKPOINT_FILE)
            logger.info("saved checkpoint %s", path)
        if self.distributed:
            dist.barrier()
        return path

    def restore_checkpoint(self, path: Union[str, Path]) -> None:
        """Resume the training state (parameters, BN statistics, optimiser,
        scheduler, step, finished epochs, EMA) from a checkpoint directory."""
        if self.state is None:
            self.setup()
        payload = load_checkpoint(path, self.device)
        self.model.load_state_dict(checkpoint_state_dict(payload), strict=True)
        self.state.optimizer.load_state_dict(payload["opt_state"])
        self.state.scheduler.load_state_dict(payload["scheduler"])
        self.state.step = int(payload["step"])
        self.epochs_done = int(payload["epoch"])
        if self.state.ema_params is not None:
            self.state.ema_params = {k: v.to(self.device) for k, v in payload["ema_params"].items()}
        logger.info("restored checkpoint %s (step %d)", path, self.state.step)
