"""Closed train->eval capability proof on synthetic data.

Counterpart of `diffusiondrive_tpu/script/run_capability_loop.py`: the
same loop through the port's pipeline, on the card unless `--device cpu`:

1. build a fleet of synthetic straight-road logs at different ego speeds
   (the speed is readable from the ego status the model consumes, and the GT
   future continues it: a signal the model can learn from its inputs);
2. build features/targets with `TransfuserFeatureBuilder` /
   `TransfuserTargetBuilder` and train the dryrun-size DiffusionDrive model
   (float32) with the `Trainer` (one checkpoint, `epoch_<N-1>/state.pt`);
3. build metric caches for HELD-OUT logs with `MetricCacheProcessor`
   (PDM-Closed, straight-road map);
4. score the trained checkpoint vs the untrained init through
   `run_pdm_score_evaluation` (feature builder -> batched bf16 forward ->
   simulate -> score), plus the human-replay upper bound for context.

The artifact (`capability_loop.json`) must show trained PDMS > untrained
PDMS by more than 0.1 on the held-out tokens (`ok`; `main` exits 1
otherwise). Beside the JAX script's keys it records each stage's wall
seconds (`stage_s`) and each stage's kernel launches (`launches`).

Usage:
    python -m diffusiondrive_torch.script.run_capability_loop --out <dir>
    # small CPU run:
    python -m diffusiondrive_torch.script.run_capability_loop --device cpu --out <dir> \\
        --num-frames 16 --batch-size 4 --epochs 2
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

TRAIN_SPEEDS = (3.0, 5.0, 7.0, 9.0)
HOLDOUT_SPEEDS = (4.0, 8.0)
MIN_MARGIN = 0.1


def _tiny_config():
    """Dryrun-size model: full architecture, 1/4 spatial extent (the JAX
    script's, field for field)."""
    from diffusiondrive_torch.models.config import TransfuserConfig

    return TransfuserConfig(
        image_architecture="resnet18", lidar_architecture="resnet18",
        camera_height=64, camera_width=256,
        lidar_resolution_height=64, lidar_resolution_width=64,
        # 1 px/m so the feature builder's +-32 m histogram is 64x64, the
        # model's lidar resolution
        pixels_per_meter=1.0,
        img_vert_anchors=2, img_horz_anchors=8,
        lidar_vert_anchors=2, lidar_horz_anchors=2,
        bev_pixel_height=32, bev_pixel_width=64,
    )


def build_speed_fleet(root: Path, num_frames: int) -> None:
    """One log per speed; the GT future continues each log's constant speed."""
    from diffusiondrive_torch.utils.synthetic import build_synthetic_log

    for speed in (*TRAIN_SPEEDS, *HOLDOUT_SPEEDS):
        build_synthetic_log(
            root, num_frames=num_frames, log_name=f"speed_{speed:.0f}",
            speed=speed, with_sensor_blobs=True, obstacle_x=None,
        )


def _token_batches(loader, tokens: List[str], map_api, agent, batch_size: int):
    """Features+targets for `tokens` via the agent's builders, stacked into
    fixed-size batches (dropping the remainder, like a DataLoader)."""
    fb = agent.get_feature_builders()[0]
    tb = agent.get_target_builders()[0]
    samples = []
    for token in tokens:
        scene = loader.get_scene_from_token(token)
        scene.map_api = map_api
        sample = dict(fb.compute_features(scene.get_agent_input()))
        sample.update(tb.compute_targets(scene))
        samples.append(sample)
    batches = []
    for s in range(0, len(samples) - batch_size + 1, batch_size):
        chunk = samples[s : s + batch_size]
        batches.append({k: np.stack([c[k] for c in chunk]) for k in chunk[0]})
    return batches


def _mean_pdms(rows: List[Dict]) -> float:
    scores = [r["score"] for r in rows if r["valid"]]
    assert scores, "no valid rows"
    return float(np.mean(scores))


def run_capability_loop(
    out_dir: Path,
    num_frames: int = 40,
    batch_size: int = 8,
    num_epochs: int = 30,
    lr: float = 1e-3,
    seed: int = 0,
    eval_human: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.agents.human_agent import HumanAgent
    from diffusiondrive_torch.common.dataclasses import SceneFilter
    from diffusiondrive_torch.common.dataloader import MetricCacheLoader, SceneLoader
    from diffusiondrive_torch.device import resolve_device
    from diffusiondrive_torch.entry import build_model
    from diffusiondrive_torch.evaluate.runner import run_pdm_score_evaluation
    from diffusiondrive_torch.ops import kernel_counters
    from diffusiondrive_torch.planning.metric_caching import MetricCacheProcessor
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer
    from diffusiondrive_torch.utils.synthetic import make_straight_map

    device = resolve_device(device)
    counters = kernel_counters()
    stage_s: Dict[str, float] = {}
    launches: Dict[str, Dict[str, int]] = {}

    class _stage:
        """Times a stage and counts its kernel launches."""

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0, self.before = time.perf_counter(), {k: f.launches for k, f in counters.items()}

        def __exit__(self, *exc):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stage_s[self.name] = time.perf_counter() - self.t0
            launches[self.name] = {k: f.launches - self.before[k] for k, f in counters.items()
                                   if f.launches - self.before[k]}

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data_root = out_dir / "data"
    if data_root.exists():
        shutil.rmtree(data_root)
    with _stage("fleet"):
        build_speed_fleet(data_root, num_frames)
    map_api = make_straight_map()

    config = _tiny_config()
    agent = DiffusionDriveAgent(config=config, device=device)
    loader = SceneLoader(
        data_root / "logs", data_root / "blobs", SceneFilter(frame_interval=1),
        agent.get_sensor_config(), build_map_api=False,
    )
    per_log = loader.get_tokens_list_per_log()
    holdout_logs = {f"speed_{s:.0f}" for s in HOLDOUT_SPEEDS}
    train_tokens = [t for log, toks in per_log.items() if log not in holdout_logs for t in toks]
    holdout_tokens = [t for log, toks in per_log.items() if log in holdout_logs for t in toks]
    logger.info("train tokens: %d, holdout tokens: %d", len(train_tokens), len(holdout_tokens))

    # ---- train --------------------------------------------------------------
    with _stage("features"):
        batches = _token_batches(loader, train_tokens, map_api, agent, batch_size)
    assert batches, "not enough train tokens for one batch"
    opt_cfg = OptimizerConfig(lr=lr, epochs=num_epochs, warmup_epochs=2,
                              steps_per_epoch=len(batches))
    trainer = Trainer(build_model(config, torch.float32, seed=seed).to(device), config, opt_cfg,
                      output_dir=str(out_dir / "train"), seed=seed)

    rng = np.random.default_rng(seed)

    def train_batches(epoch: int):
        for i in rng.permutation(len(batches)):
            yield batches[i]

    with _stage("train"):
        trainer.fit(train_batches, num_epochs=num_epochs, log_every=50,
                    checkpoint_every_epochs=num_epochs)  # single final checkpoint
    ckpt = out_dir / "train" / f"epoch_{num_epochs - 1:04d}"
    assert ckpt.exists(), f"missing checkpoint {ckpt}"

    # ---- metric caches for the held-out logs --------------------------------
    cache_dir = out_dir / "metric_cache"
    if cache_dir.exists():
        shutil.rmtree(cache_dir)
    processor = MetricCacheProcessor(str(cache_dir), device=device)
    with _stage("cache"):
        for token in holdout_tokens:
            scene = loader.get_scene_from_token(token)
            processor.compute_metric_cache(scene, map_api)
    cache_loader = MetricCacheLoader(cache_dir)

    # ---- evaluate trained vs untrained (vs human replay) --------------------
    holdout_loader = SceneLoader(
        data_root / "logs", data_root / "blobs",
        SceneFilter(frame_interval=1, tokens=holdout_tokens),
        agent.get_sensor_config(), build_map_api=False,
    )

    def evaluate(name, eval_agent) -> float:
        with _stage(f"evaluate_{name}"):
            rows = run_pdm_score_evaluation(eval_agent, holdout_loader, cache_loader,
                                            batch_size=batch_size, device=device)
        return _mean_pdms(rows)

    results = {
        "untrained_pdms": evaluate("untrained", DiffusionDriveAgent(config=config, seed=seed, device=device)),
        "trained_pdms": evaluate(
            "trained", DiffusionDriveAgent(config=config, checkpoint_path=str(ckpt), device=device)),
        "num_train_tokens": len(train_tokens),
        "num_holdout_tokens": len(holdout_tokens),
        "train_speeds": list(TRAIN_SPEEDS),
        "holdout_speeds": list(HOLDOUT_SPEEDS),
        "num_epochs": num_epochs,
        "steps_per_epoch": len(batches),
    }
    if eval_human:
        results["human_replay_pdms"] = evaluate("human", HumanAgent())
    results["margin"] = results["trained_pdms"] - results["untrained_pdms"]
    results["ok"] = bool(results["margin"] > MIN_MARGIN)
    results["stage_s"] = stage_s
    results["launches"] = launches
    results["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)

    (out_dir / "capability_loop.json").write_text(json.dumps(results, indent=2))
    logger.info("capability loop: %s", results)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--num-frames", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--no-human", action="store_true")
    parser.add_argument("--device", default=None, help="default: the current CUDA device; 'cpu' for the CPU")
    args = parser.parse_args(argv)
    results = run_capability_loop(
        args.out, num_frames=args.num_frames, batch_size=args.batch_size,
        num_epochs=args.epochs, lr=args.lr, eval_human=not args.no_human, device=args.device,
    )
    print(json.dumps(results))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
