"""Training entry point of the port (counterpart of `diffusiondrive_tpu/script/run_training.py`).

Builds the agent from the registry, caches or loads the dataset and trains
on one device: the DiffusionDrive agents through the port's `Trainer`
(compute dtype from `precision`, float32 parameters and optimiser state;
the default `bf16-mixed` is bf16 compute), simple agents (e.g.
`ego_status_mlp_agent`) through `training/generic.py:train_agent`, their
final weights saved as `<output_dir>/final.pt`. The dataset is the scene-backed
`Dataset` (logs and sensor blobs read from disk, the feature cache written
at `cache_path` first, resumably) or, with `--cache-only`, the cache alone.
Takes the JAX CLI's flags and `--config` composition, plus `--device`; the
resolved config is snapshotted to `<output_dir>/config.yaml`.

Example (one GPU):
    python -m diffusiondrive_torch.script.run_training --config default_training \\
        navsim_log_path=<logs> sensor_blobs_path=<blobs> cache_path=<cache> batch_size=64
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional, Sequence

from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.config.registry import agent_from_config, load_split, scene_filter_from_split
from diffusiondrive_torch.device import resolve_device
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
    device = resolve_device(cfg.get("device"))

    # precision -> the model's compute dtype (parameters and optimiser stay
    # float32; the reference's `precision: 16-mixed`)
    precision = str(cfg.get("precision", "bf16-mixed"))
    if precision not in DTYPE_OF:
        raise ValueError(f"unknown precision {precision!r}; expected one of {sorted(DTYPE_OF)}")
    if "diffusion" in cfg["agent"]["name"] or "transfuser" in cfg["agent"]["name"]:
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
        dataset = Dataset(scene_loader(cfg, "split", agent.get_sensor_config()), feature_builders,
                          target_builders, cache_path=cfg["cache_path"])

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
        val_dataset = Dataset(scene_loader(cfg, "val_split", agent.get_sensor_config()), feature_builders,
                              target_builders, cache_path=cfg["cache_path"])
        val_batches = lambda epoch: batch_iterator(val_dataset, batch_size, shuffle=False)  # noqa: E731
    trainer.fit(
        lambda epoch: batch_iterator(dataset, batch_size, shuffle=True, seed=seed + epoch),
        num_epochs=epochs,
        val_batches=val_batches,
        checkpoint_every_epochs=int(cfg.get("checkpoint_every_epochs", 1)),
    )


if __name__ == "__main__":
    main()
