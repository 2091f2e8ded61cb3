"""Metric caching entry point of the port.

Counterpart of `diffusiondrive_tpu/script/run_metric_caching.py` (navsim's
`run_metric_caching.py`): PDM-Closed over the split's scenes through the
port's `planning/metric_caching.py:cache_data`, each planner call's
simulate and score on `--device` (default: the current CUDA device; it
raises without one unless `--device cpu` is given). The thread count is
`--num-workers`, else the config's `worker.max_workers`, else 8.

Example:
    python -m diffusiondrive_torch.script.run_metric_caching \\
        --navsim-log-path <logs> --metric-cache-path <cache>
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Optional, Sequence

from diffusiondrive_torch.common.dataclasses import SensorConfig
from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.config.registry import load_split, scene_filter_from_split
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.planning.metric_caching import cache_data
from diffusiondrive_torch.script.cli_common import add_device_arg, resolve_run_config, snapshot_config


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default=None,
                        help="composed config (name under configs/ or a YAML path)")
    parser.add_argument("--navsim-log-path", default=os.environ.get("OPENSCENE_DATA_ROOT"))
    parser.add_argument("--split", default=None)
    parser.add_argument("--output-dir", default=os.environ.get("NAVSIM_EXP_ROOT", "exp"))
    parser.add_argument("--metric-cache-path", default=None)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--host-id", type=int, default=int(os.environ.get("HOST_ID", 0)))
    parser.add_argument("--num-hosts", type=int, default=int(os.environ.get("NUM_HOSTS", 1)))
    add_device_arg(parser)
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)

    cfg = resolve_run_config(args)
    if args.metric_cache_path:
        cfg["metric_cache_path"] = args.metric_cache_path
    if not cfg.get("metric_cache_path"):
        parser.error("--metric-cache-path (or metric_cache_path in --config) is required")
    snapshot_config(cfg, Path(cfg["output_dir"]))
    device = resolve_device(cfg.get("device"))

    split = load_split(cfg.get("split"))
    scene_loader = SceneLoader(
        Path(cfg["navsim_log_path"]),
        None,
        scene_filter_from_split(split),
        SensorConfig.build_no_sensors(),
    )
    num_workers = cfg.get("num_workers") or (cfg.get("worker") or {}).get("max_workers", 8)
    cache_data(
        scene_loader,
        cfg["metric_cache_path"],
        force=bool(cfg.get("force")),
        num_workers=int(num_workers),
        host_id=int(cfg.get("host_id", 0)),
        num_hosts=int(cfg.get("num_hosts", 1)),
        device=device,
    )


if __name__ == "__main__":
    main()
