"""PDMS evaluation entry point of the port.

Counterpart of `diffusiondrive_tpu/script/run_pdm_score.py` (navsim's
`run_pdm_score.py`): the agent from the registry, scenes from the logs
(sensors read from disk, no map API), the metric cache, then the port's
`evaluate/runner.py:run_pdm_score_evaluation` and its CSV. The agent and
the simulation and scoring run on `--device` (default: the current CUDA
device; it raises without one unless `--device cpu` is given).
`--mesh-devices N` splits each batch's agent forward and its simulate and
score over N local devices of `--device`'s type (-1: all of them; the
CPU counts as one device), as the JAX CLI's flag does.

Example:
    python -m diffusiondrive_torch.script.run_pdm_score --agent diffusiondrive_agent \\
        --navsim-log-path <logs> --sensor-blobs-path <blobs> \\
        --metric-cache-path <cache> --split navtest --output-dir <out>
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Optional, Sequence

from diffusiondrive_torch.common.dataloader import MetricCacheLoader, SceneLoader
from diffusiondrive_torch.config.registry import agent_from_config, load_split, scene_filter_from_split
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.evaluate.runner import run_pdm_score_evaluation, write_score_csv
from diffusiondrive_torch.parallel.mesh import local_devices
from diffusiondrive_torch.script.cli_common import add_common_args, resolve_run_config, snapshot_config


def main(argv: Optional[Sequence[str]] = None) -> Path:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(parser)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--metric-cache-path", default=None)
    parser.add_argument(
        "--mesh-devices", type=int, default=0,
        help="shard the eval batch over this many local devices "
             "(0 = single-device; -1 = all local devices)")
    args = parser.parse_args(argv)

    cfg = resolve_run_config(args)
    cfg.setdefault("metric_cache_path", args.metric_cache_path)
    if args.metric_cache_path:
        cfg["metric_cache_path"] = args.metric_cache_path
    if not cfg.get("metric_cache_path"):
        parser.error("--metric-cache-path (or metric_cache_path in --config) is required")
    device = resolve_device(cfg.get("device"))
    try:
        mesh = local_devices(int(cfg.get("mesh_devices", args.mesh_devices)), device)
    except ValueError as err:
        raise SystemExit(str(err)) from err

    agent = agent_from_config(cfg["agent"], device=device)
    split = load_split(cfg.get("split"))
    scene_loader = SceneLoader(
        Path(cfg["navsim_log_path"]),
        Path(cfg["sensor_blobs_path"]) if cfg.get("sensor_blobs_path") else None,
        scene_filter_from_split(split),
        agent.get_sensor_config(),
        build_map_api=False,
    )
    metric_cache_loader = MetricCacheLoader(Path(cfg["metric_cache_path"]))

    snapshot_config(cfg, Path(cfg["output_dir"]))
    rows = run_pdm_score_evaluation(
        agent,
        scene_loader,
        metric_cache_loader,
        batch_size=int(cfg.get("batch_size", 32)),
        host_id=int(cfg.get("host_id", 0)),
        num_hosts=int(cfg.get("num_hosts", 1)),
        device=device,
        mesh=mesh,
    )
    out = write_score_csv(rows, Path(cfg["output_dir"]))
    print(json.dumps({"output_csv": str(out), "num_tokens": len(rows)}))
    return out


if __name__ == "__main__":
    main()
