"""Training entry point of the port (counterpart of `diffusiondrive_tpu/script/run_training.py`).

Builds the agent from the registry, caches or loads the dataset and trains:
the DiffusionDrive agents through the port's `Trainer`
(compute dtype from `precision`, float32 parameters and optimiser state;
the default `bf16-mixed` is bf16 compute), simple agents (e.g.
`ego_status_mlp_agent`) through `training/generic.py:train_agent`, their
final weights saved as `<output_dir>/final.pt`. The dataset is the scene-backed
`Dataset` (logs and sensor blobs read from disk, the feature cache written
at `cache_path` first, resumably) or, with `--cache-only`, the cache alone.
Takes the JAX CLI's flags and `--config` composition, plus `--device`; the
resolved config is snapshotted to `<output_dir>/config.yaml`.

Like the JAX trainer, which trains on every local device, the DiffusionDrive
agents train data-parallel (`DistributedDataParallel`, NCCL) on every
visible card: under `torchrun` each process is the rank the launcher
gives it (card `LOCAL_RANK`); otherwise, with more than one visible card
and no `--device`, one rank a card is spawned. `batch_size` is the global
batch, split evenly over the ranks. One card, or `--device`, trains as one
process. Simple agents train on one device.

Example (one GPU):
    python -m diffusiondrive_torch.script.run_training --config default_training \\
        navsim_log_path=<logs> sensor_blobs_path=<blobs> cache_path=<cache> batch_size=64
Example (N GPUs of one host, explicitly):
    torchrun --nproc-per-node N -m diffusiondrive_torch.script.run_training \\
        --cache-path <cache> --cache-only --batch-size 64
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.config.registry import agent_from_config, load_split, scene_filter_from_split
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.parallel.distributed import initialize_distributed, launch
from diffusiondrive_torch.script.cli_common import add_common_args, resolve_run_config, snapshot_config
from diffusiondrive_torch.training.dataset import CacheOnlyDataset, Dataset, batch_iterator
from diffusiondrive_torch.training.train import OptimizerConfig
from diffusiondrive_torch.training.trainer import Trainer

DTYPE_OF = {"bf16-mixed": "bfloat16", "16-mixed": "bfloat16",
            "fp32": "float32", "32": "float32", "float32": "float32"}


def scene_loader(cfg: dict, split_key: str, sensor_config) -> SceneLoader:
    return SceneLoader(
        Path(cfg["navsim_log_path"]),
        Path(cfg["sensor_blobs_path"]) if cfg.get("sensor_blobs_path") else None,
        scene_filter_from_split(load_split(cfg.get(split_key))),
        sensor_config,
    )


def _trains_with_trainer(cfg: dict) -> bool:
    """The DiffusionDrive agents train through `Trainer` (and data-parallel);
    simple agents through `training/generic.py`."""
    return "diffusion" in cfg["agent"]["name"] or "transfuser" in cfg["agent"]["name"]


def _rank0_first(rank: int, world: int, build):
    """`build()` on rank 0 first (it may write the feature cache), then on
    the other ranks, which find the cache complete."""
    if world > 1 and rank != 0:
        dist.barrier()
    out = build()
    if world > 1 and rank == 0:
        dist.barrier()
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(parser, default_agent="diffusiondrive_agent")
    parser.add_argument("--cache-path", default=None, help="feature/target cache directory")
    parser.add_argument("--cache-only", action="store_true", help="train purely from cache")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--warmup-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=6e-4)
    parser.add_argument("--ema-decay", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    cfg = resolve_run_config(args)
    if args.cache_path:
        cfg["cache_path"] = args.cache_path
    if not cfg.get("cache_path"):
        parser.error("--cache-path (or cache_path in --config) is required")
    snapshot_config(cfg, Path(cfg["output_dir"]))
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1 or dist.is_initialized()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not launched and cfg.get("device") is None and cards > 1 and _trains_with_trainer(cfg):
        launch(_train_rank, cards, args=(cfg,), device="cuda")
        return
    train(cfg)


def _train_rank(rank: int, world: int, device: torch.device, cfg: dict) -> None:
    """One spawned rank of `main` (the group is joined already)."""
    train({**cfg, "device": str(device)})


def train(cfg: dict) -> None:
    """Train the configured agent; under `torchrun` (or in a group already
    joined) as this process's rank, on card `LOCAL_RANK` unless
    `cfg["device"]` names one."""
    device = cfg.get("device")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank, world = initialize_distributed(device=device)
    if world > 1 and not _trains_with_trainer(cfg):
        raise SystemExit(f"Agent '{cfg['agent']['name']}' trains on one device; run it as one process.")

    # precision -> the model's compute dtype (parameters and optimiser stay
    # float32; the reference's `precision: 16-mixed`)
    precision = str(cfg.get("precision", "bf16-mixed"))
    if precision not in DTYPE_OF:
        raise ValueError(f"unknown precision {precision!r}; expected one of {sorted(DTYPE_OF)}")
    if _trains_with_trainer(cfg):
        cfg["agent"].setdefault("dtype", DTYPE_OF[precision])
    agent = agent_from_config(cfg["agent"], device=device)
    feature_builders = agent.get_feature_builders()
    target_builders = agent.get_target_builders()

    epochs = int(cfg.get("epochs", 100))
    batch_size = int(cfg.get("batch_size", 64))
    seed = int(cfg.get("seed", 0))

    if cfg.get("cache_only"):
        dataset = CacheOnlyDataset(cfg["cache_path"], feature_builders, target_builders)
    else:
        dataset = _rank0_first(rank, world, lambda: Dataset(
            scene_loader(cfg, "split", agent.get_sensor_config()), feature_builders, target_builders,
            cache_path=cfg["cache_path"]))

    if not hasattr(agent, "model"):
        raise SystemExit(f"Agent '{cfg['agent']['name']}' does not support training.")

    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent

    if not isinstance(agent, DiffusionDriveAgent):
        # simple agents (e.g. ego_status_mlp_agent) train through the generic loop
        from diffusiondrive_torch.training.generic import train_agent

        train_agent(agent, dataset, batch_size, epochs, seed=seed)
        agent.save_checkpoint(Path(cfg["output_dir"]) / "final.pt")
        return

    agent.initialize()
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    opt_cfg = OptimizerConfig(
        lr=float(cfg.get("lr", 6e-4)),
        epochs=epochs,
        warmup_epochs=int(cfg.get("warmup_epochs", 3)),
        steps_per_epoch=steps_per_epoch,
        weight_decay=agent.config.weight_decay,
        ema_decay=cfg.get("ema_decay"),
    )
    trainer = Trainer(agent.model, agent.config, opt_cfg, output_dir=cfg["output_dir"], seed=seed,
                      callbacks=agent.get_training_callbacks(output_dir=cfg["output_dir"]))
    val_batches = None
    if cfg.get("val_split"):
        val_dataset = _rank0_first(rank, world, lambda: Dataset(
            scene_loader(cfg, "val_split", agent.get_sensor_config()), feature_builders, target_builders,
            cache_path=cfg["cache_path"]))
        val_batches = lambda epoch: batch_iterator(val_dataset, batch_size, shuffle=False,  # noqa: E731
                                                   rank=rank, world_size=world)
    trainer.fit(
        lambda epoch: batch_iterator(dataset, batch_size, shuffle=True, seed=seed + epoch,
                                     rank=rank, world_size=world),
        num_epochs=epochs,
        val_batches=val_batches,
        checkpoint_every_epochs=int(cfg.get("checkpoint_every_epochs", 1)),
    )


if __name__ == "__main__":
    main()
