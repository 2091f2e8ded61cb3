"""The model's operations, counted once per configuration and batch over the
benchmark's own reference on the `meta` device, so that no change to the
program's kernels can move the count. `torch.utils.flop_counter` counts the
products (convolutions, matrix products and their gradients) at 2 operations
a multiply-add; the elementwise work is left out, as a peak's share takes it.

    python -m benchmark.harness.flops <config file> [--batch 2]

prints the counts a sample that the configuration file records under `flops`.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import is_parameter
from benchmark.reference.model import Draws, Net
from benchmark.reference.precision import Precision


def meta_weights(specs: dict) -> dict:
    return {k: torch.empty(tuple(shape), device="meta", requires_grad=is_parameter(k)) for k, shape in specs.items()}


def count(cfg: dict, specs: dict, batch: int, train: bool) -> int:
    """Operations of one forward (eval) or one forward and backward (train) at `batch`."""
    W = meta_weights(specs)
    B, M, P = batch, cfg["ego_fut_mode"], cfg["num_poses"]
    camera = torch.empty((B, cfg["camera_height"], cfg["camera_width"], 3), device="meta")
    lidar = torch.empty((B, cfg["lidar_resolution_height"], cfg["lidar_resolution_width"], 1), device="meta")
    status = torch.empty((B, 8), device="meta")
    noise = torch.empty((B, M, P, 2), device="meta")
    draws = Draws(None, torch.zeros((B,), dtype=torch.long, device="meta"), noise)
    with FlopCounterMode(display=False) as counter:
        out = Net(W, cfg, Precision("float32"), train=train, draws=draws, recompute=False)(camera, lidar, status)
        if train:
            total = sum(v.float().sum() for k, v in out.items() if k != "plan_anchor" and v.is_floating_point())
            total.backward()
    return int(counter.get_total_flops())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config")
    parser.add_argument("--batch", type=int, default=2)
    args = parser.parse_args(argv)
    doc = json.loads(Path(args.config).read_text())
    cfg, specs = doc["as_run"], doc["weights"]
    out = {"train_per_sample": count(cfg, specs, args.batch, True) / args.batch,
           "eval_per_scene": count(cfg, specs, args.batch, False) / args.batch}
    json.dump(out, sys.stdout)
    print()


if __name__ == "__main__":
    main()
