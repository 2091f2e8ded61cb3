"""Generate k-means plan anchors for the diffusion trajectory head.

Counterpart of `diffusiondrive_tpu/script/make_plan_anchors.py`, with the
same flags: k-means over GT future trajectories from either a cached
dataset (`--cache-path`) or raw logs (`--navsim-log-path`). The resulting
(modes, poses, 2) .npy plugs into `TransfuserConfig.plan_anchor_path`. It
runs on the host (numpy) and writes the JAX CLI's anchors bit for bit.

Example:
    python -m diffusiondrive_torch.script.make_plan_anchors \\
        --cache-path $NAVSIM_EXP_ROOT/training_cache --out anchors_20.npy
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from diffusiondrive_torch.utils.anchors import (
    collect_trajectories_from_cache,
    collect_trajectories_from_scenes,
    kmeans_plan_anchors,
)

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cache-path", default=None, help="cached dataset root (gz targets)")
    parser.add_argument("--navsim-log-path", default=os.environ.get("OPENSCENE_DATA_ROOT"))
    parser.add_argument("--split", default=None)
    parser.add_argument("--out", required=True, help="output .npy path")
    parser.add_argument("--num-modes", type=int, default=20)
    parser.add_argument("--num-poses", type=int, default=8)
    parser.add_argument("--num-iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if args.cache_path:
        trajectories = collect_trajectories_from_cache(Path(args.cache_path))
    elif args.navsim_log_path:
        from diffusiondrive_torch.common.dataclasses import SensorConfig
        from diffusiondrive_torch.common.dataloader import SceneLoader
        from diffusiondrive_torch.config.registry import load_split, scene_filter_from_split

        split = load_split(args.split)
        loader = SceneLoader(Path(args.navsim_log_path), None, scene_filter_from_split(split),
                             SensorConfig.build_no_sensors(), build_map_api=False)
        trajectories = collect_trajectories_from_scenes(loader, args.num_poses)
    else:
        parser.error("one of --cache-path / --navsim-log-path is required")

    logger.info("k-means over %d trajectories of %d poses", len(trajectories), trajectories.shape[1])
    anchors = kmeans_plan_anchors(trajectories, args.num_modes, args.num_iters, args.seed)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, anchors)
    logger.info("wrote %s anchors -> %s", anchors.shape, out)


if __name__ == "__main__":
    main()
