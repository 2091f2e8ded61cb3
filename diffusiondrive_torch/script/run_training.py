"""Training entry point of the port (counterpart of `diffusiondrive_tpu/script/run_training.py`).

Trains the DiffusionDrive agent from a feature/target cache (the JAX
package's cache format, `training/dataset.py`) on one device, in bf16
compute with float32 parameters and optimiser state (the JAX CLI's default
`precision: bf16-mixed`). It takes the JAX CLI's legacy flags with their
defaults, plus `--device`. Not ported yet (they raise, naming ROADMAP item
17): `--config` composition and positional overrides, agents other than
`diffusiondrive_agent` (the registry and the generic loop of simple agents),
and training without `--cache-only` (the scene-backed `Dataset`).

Example (one GPU):
    python -m diffusiondrive_torch.script.run_training --cache-path <cache> --cache-only \\
        --epochs 100 --batch-size 64 --device cuda
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path
from typing import Dict, Optional

import torch

from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.training.dataset import CacheOnlyDataset, batch_iterator
from diffusiondrive_torch.training.train import OptimizerConfig
from diffusiondrive_torch.training.trainer import Trainer

AGENT = "diffusiondrive_agent"
NOT_PORTED = "is not ported yet (ROADMAP item 17)"


def add_common_args(parser: argparse.ArgumentParser, default_agent: str = AGENT) -> None:
    """The legacy flags of `diffusiondrive_tpu/script/cli_common.py`."""
    parser.add_argument("--config", default=None, help=f"composed config: {NOT_PORTED}")
    parser.add_argument("--navsim-log-path", default=os.environ.get("OPENSCENE_DATA_ROOT"))
    parser.add_argument("--sensor-blobs-path", default=os.environ.get("OPENSCENE_SENSOR_ROOT"))
    parser.add_argument("--split", default=None, help="split name in splits/ or a YAML path")
    parser.add_argument("--output-dir", default=os.environ.get("NAVSIM_EXP_ROOT", "exp"))
    parser.add_argument("--agent", default=default_agent)
    parser.add_argument("--agent-config", default=None, help="YAML of agent kwargs")
    parser.add_argument("--host-id", type=int, default=int(os.environ.get("HOST_ID", 0)))
    parser.add_argument("--num-hosts", type=int, default=int(os.environ.get("NUM_HOSTS", 1)))
    parser.add_argument("overrides", nargs="*", default=[], help=f"config overrides: {NOT_PORTED}")


def load_yaml(path: Optional[str]) -> Dict:
    """A YAML file's mapping (empty without a path)."""
    if not path:
        return {}
    import yaml

    with open(path) as fp:
        return yaml.safe_load(fp) or {}


def resolve_run_config(args: argparse.Namespace) -> Dict:
    """The legacy flags mapped onto the run-config keys."""
    if args.config or args.overrides:
        raise NotImplementedError(f"--config and positional overrides: config composition {NOT_PORTED}")
    cfg = {k: v for k, v in vars(args).items() if k not in ("config", "overrides", "agent_config")}
    cfg["agent"] = {"name": args.agent, **load_yaml(args.agent_config)}
    return cfg


def build_agent(agent_cfg: Dict, seed: int, device: Optional[str]) -> DiffusionDriveAgent:
    """The DiffusionDrive agent from its kwargs (a `config` mapping becomes
    a `TransfuserConfig`), in bf16 compute."""
    kwargs = {k: v for k, v in agent_cfg.items() if k != "name"}
    if agent_cfg["name"] != AGENT:
        raise NotImplementedError(f"agent {agent_cfg['name']!r}: the agent registry and the generic "
                                  f"training loop {NOT_PORTED}; the port trains {AGENT!r}")
    if isinstance(kwargs.get("config"), dict):
        kwargs["config"] = TransfuserConfig(**kwargs["config"])
    kwargs.setdefault("seed", seed)
    return DiffusionDriveAgent(dtype=torch.bfloat16, device=device, **kwargs)


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(parser)
    parser.add_argument("--cache-path", default=None, help="feature/target cache directory")
    parser.add_argument("--cache-only", action="store_true", help="train purely from the cache")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--warmup-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=6e-4)
    parser.add_argument("--ema-decay", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = parser.parse_args()

    cfg = resolve_run_config(args)
    if not cfg.get("cache_path"):
        parser.error("--cache-path is required")
    if not cfg.get("cache_only"):
        raise NotImplementedError(f"training without --cache-only (the scene-backed Dataset) {NOT_PORTED}")
    output_dir = Path(cfg["output_dir"])
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "config.json").write_text(json.dumps(cfg, indent=2, default=str))

    agent = build_agent(cfg["agent"], args.seed, args.device)
    agent.initialize()
    dataset = CacheOnlyDataset(cfg["cache_path"], agent.get_feature_builders(), agent.get_target_builders())
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    opt_cfg = OptimizerConfig(lr=args.lr, epochs=args.epochs, warmup_epochs=args.warmup_epochs,
                              steps_per_epoch=steps_per_epoch, weight_decay=agent.config.weight_decay,
                              ema_decay=args.ema_decay)
    trainer = Trainer(agent.model, agent.config, opt_cfg, output_dir=str(output_dir), seed=args.seed,
                      callbacks=agent.get_training_callbacks(output_dir=str(output_dir)))
    trainer.fit(lambda epoch: batch_iterator(dataset, args.batch_size, shuffle=True, seed=args.seed + epoch),
                num_epochs=args.epochs)


if __name__ == "__main__":
    main()
