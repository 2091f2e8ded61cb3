"""Training orchestration: epochs, logging, checkpoints.

Counterpart of `diffusiondrive_tpu/training/trainer.py` on one device. The
per-step work is `train.train_step`; this class runs the host loop: batch
iteration and the copy to the device, the deferred metric fetch, callback
hooks, a per-step `metrics.jsonl`, validation (of the EMA weights too) and
checkpoints.

Each step's draws (the diffusion timesteps and noise, every dropout mask)
come from one generator on the device, seeded from (`seed + 1`, step), as
the JAX trainer folds the step into its key: a resumed run draws what the
uninterrupted run would have, with no saved generator state.

A checkpoint is a directory ``epoch_<NNNN>`` holding ``state.pt``
(`torch.save`) with what the JAX package's orbax checkpoint holds: params,
BN statistics, constants, optimiser state, step and EMA params, plus the
LR scheduler and the number of finished epochs.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from diffusiondrive_torch.models.config import TransfuserConfig
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
    """The train loop on the model's device."""

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
        self._val_fn = make_val_step(self.model, model_config)
        self._eval_fn = make_eval_step(self.model)
        self._generator = torch.Generator(device=self.device)
        self._metrics_fp = None

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
        if self.output_dir is None:
            return
        if self._metrics_fp is None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            self._metrics_fp = open(self.output_dir / "metrics.jsonl", "a")
        row = {"split": split, "epoch": epoch, "step": step,
               **{k: round(float(v), 6) for k, v in metrics.items()}}
        self._metrics_fp.write(json.dumps(row) + "\n")
        self._metrics_fp.flush()

    def setup(self) -> None:
        """Create the optimiser state (and the EMA copy) for the model."""
        self.state = create_train_state(self.model, self.opt_cfg)

    def step_generator(self, step: int) -> torch.Generator:
        """The device generator re-seeded for `step` from (seed + 1, step)."""
        seed = np.random.SeedSequence([self.seed + 1, step]).generate_state(1, np.uint64)[0]
        return self._generator.manual_seed(int(seed))

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy batch on the trainer's device. On CUDA the arrays are
        pinned first, so the copies run asynchronously on the stream."""
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
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
                metrics = train_step(self.state, self.model_config, tensors,
                                     self.step_generator(self.state.step))
                count += 1
                pending.append((self.state.step, metrics))
                if count % log_every == 0:
                    logger.info("epoch %d step %d: %s", epoch, count,
                                {k: round(v, 4) for k, v in flush_pending().items()})
            flush_pending()
            means = {k: v / max(count, 1) for k, v in metrics_acc.items()}
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
        feeds any `on_validation_batch` callback with the eval outputs."""
        if self.state is None:
            self.setup()
        wants_outputs = any(getattr(cb, "on_validation_batch", None) for cb in self.callbacks)
        variants = [("", None)]
        if self.state.ema_params is not None:
            variants.append(("ema_", self.state.ema_params))
        totals: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in batches:
            tensors = self.to_device(batch)
            for prefix, params in variants:
                metrics = self._val_fn(tensors, self._generator.manual_seed(0), params)
                for k, v in metrics.items():
                    totals[prefix + k] = totals.get(prefix + k, 0.0) + v
            if count == 0 and wants_outputs:
                outputs = self._eval_fn(tensors, self._generator.manual_seed(0))
                outputs = {k: v.float().cpu().numpy() for k, v in outputs.items()}
                self._hook("on_validation_batch", epoch, batch, outputs, 0)
            count += 1
        fetched = self._fetch([totals])
        means = {k: v / max(count, 1) for k, v in (fetched[0] if fetched else {}).items()}
        self.last_val_metrics = means
        self._log_metrics("val", epoch, self.state.step, means)
        logger.info("epoch %d val: %s", epoch, {k: round(v, 4) for k, v in means.items()})
        return means

    def save_checkpoint(self, epoch: int) -> Path:
        path = (self.output_dir / f"epoch_{epoch:04d}").absolute()
        path.mkdir(parents=True, exist_ok=True)
        payload = {**split_state_dict(self.model),
                   "opt_state": self.state.optimizer.state_dict(),
                   "scheduler": self.state.scheduler.state_dict(),
                   "step": self.state.step, "epoch": self.epochs_done}
        if self.state.ema_params is not None:
            payload["ema_params"] = self.state.ema_params
        torch.save(payload, path / CHECKPOINT_FILE)
        logger.info("saved checkpoint %s", path)
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
