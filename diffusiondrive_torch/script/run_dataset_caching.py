"""Feature/target cache precomputation entry point of the port.

Counterpart of `diffusiondrive_tpu/script/run_dataset_caching.py` (navsim's
`run_dataset_caching.py`): computes the gzip feature and target cache of
the agent's builders over the split, resumably (`--force` recomputes),
on `--num-workers` host threads. The cache is the JAX package's format.
The agent is built on `--device` (default: the current CUDA device; it
raises without one unless `--device cpu` is given), though its builders
run on the host.

Example:
    python -m diffusiondrive_torch.script.run_dataset_caching --config default_dataset_caching \\
        navsim_log_path=<logs> sensor_blobs_path=<blobs> cache_path=<cache>
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
from diffusiondrive_torch.training.dataset import Dataset


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(parser, default_agent="diffusiondrive_agent")
    parser.add_argument("--cache-path", default=None)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--num-workers", type=int, default=16)
    args = parser.parse_args(argv)

    cfg = resolve_run_config(args)
    if args.cache_path:
        cfg["cache_path"] = args.cache_path
    if not cfg.get("cache_path"):
        parser.error("--cache-path (or cache_path in --config) is required")
    snapshot_config(cfg, Path(cfg["output_dir"]))

    agent = agent_from_config(cfg["agent"], device=resolve_device(cfg.get("device")))
    split = load_split(cfg.get("split"))
    scene_loader = SceneLoader(
        Path(cfg["navsim_log_path"]),
        Path(cfg["sensor_blobs_path"]) if cfg.get("sensor_blobs_path") else None,
        scene_filter_from_split(split),
        agent.get_sensor_config(),
    )
    dataset = Dataset(
        scene_loader,
        agent.get_feature_builders(),
        agent.get_target_builders(),
        cache_path=cfg["cache_path"],
        force_cache_computation=bool(cfg.get("force")),
        num_workers=int(cfg.get("num_workers") or args.num_workers),
    )
    logging.info("Cached %d tokens to %s", len(dataset), cfg["cache_path"])


if __name__ == "__main__":
    main()
