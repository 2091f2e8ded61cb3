"""Sustained-training soak: 200+ steps of the full-size config on the card.

Counterpart of `diffusiondrive_tpu/script/run_soak.py`. It runs the
production-size model (ResNet-34 x2, 256x1024 camera, 256x256 BEV) in
bf16 with EMA 0.999 for `--steps` steps over a small fixed pool of
synthetic cached-feature batches (`_make_batch_pool`, the JAX script's
arrays bit for bit), moved to the device once and cycled, checkpoints
every `--checkpoint-every` steps through the `Trainer`'s epoch loop (one
epoch a checkpoint), then checks (`soak_failures`):

- `metrics.jsonl` holds exactly one row a step, steps contiguous, every
  loss term finite;
- the loss went down: last-K mean < first-K mean, and with >= 50 steps no
  fifth-of-the-run window more than 2% above the one before;
- step time is stable: each epoch after the first within `--time-tol` of
  their median (an epoch holding a profiled step timed by its other steps:
  the profiler's start, stop and trace take seconds);
- one checkpoint an epoch, and the last restores to `step == steps`.

JAX's "the step compiled exactly once" has no torch meaning; in its place
the port keeps what it can observe:

- steady launches: each hand-written kernel's `launches` counter rises by
  the same count every epoch (the default train step: one LAP a step);
- one steady step: the CUDA kernels of one step early in the run (from
  the fourth on) and of one at its end, counted under `torch.profiler`
  after a warm-up step, are equal (`profiled_steps`: neither step ends an
  epoch, whose metric fetch launches kernels of its own);
- memory: `torch.cuda.memory_allocated()` at the end of epochs 2..N equal
  within 1 MB, and each later epoch's peak within 1% of epoch 2's.

It records, and does not gate, the host-to-device copies of those two
profiled steps. On the CPU the last three are not measured (None).

Prints one JSON summary line (also written to `soak_summary.json` in the
output directory) with the JAX script's keys; `compile_cache_size` holds
the kernels of a steady step and `device` the card's name.

Usage:
    python -m diffusiondrive_torch.script.run_soak --steps 200 --batch 8
    # quick CPU run at the tiny size:
    python -m diffusiondrive_torch.script.run_soak --device cpu --tiny --steps 12 --checkpoint-every 6
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

MEMORY_TOL_BYTES = 1 << 20   # end-of-epoch allocation, epochs 2..N
PEAK_TOL = 0.01              # each later epoch's peak against epoch 2's
STEP_RANGES = ("forward", "loss", "lap", "backward", "optimizer")   # `training/train.py`'s profiler ranges


def _make_batch_pool(config, batch: int, pool: int, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """A fixed pool of synthetic cached-feature batches (the shapes the
    feature/target builders produce, `training/dataset.py`), the JAX
    script's draws in its order. Fixed so the model can fit them and the
    loss trend is a real signal."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(pool):
        batches.append({
            "camera_feature": rng.normal(size=(batch, config.camera_height, config.camera_width, 3)).astype(np.float32),
            "lidar_feature": (rng.uniform(size=(batch, config.lidar_resolution_height,
                                                config.lidar_resolution_width,
                                                config.lidar_in_channels)) < 0.02).astype(np.float32),
            "status_feature": rng.normal(size=(batch, 8)).astype(np.float32),
            "trajectory": rng.normal(scale=5.0, size=(batch, config.num_poses, 3)).astype(np.float32),
            "agent_states": rng.normal(scale=3.0, size=(batch, config.num_bounding_boxes, 5)).astype(np.float32),
            "agent_labels": (rng.uniform(size=(batch, config.num_bounding_boxes)) > 0.5).astype(np.float32),
            "bev_semantic_map": rng.integers(0, config.num_bev_classes,
                                             size=(batch,) + config.bev_semantic_frame).astype(np.int32),
        })
    return batches


def tiny_soak_config():
    """The JAX script's `--tiny` model."""
    from diffusiondrive_torch.models.config import TransfuserConfig

    return TransfuserConfig(
        image_architecture="resnet18", lidar_architecture="resnet18",
        camera_height=64, camera_width=256,
        lidar_resolution_height=64, lidar_resolution_width=64,
        img_vert_anchors=2, img_horz_anchors=8,
        lidar_vert_anchors=2, lidar_horz_anchors=2,
        bev_pixel_height=32, bev_pixel_width=64,
        tf_d_model=64, tf_d_ffn=128, tf_num_layers=1, tf_num_head=4,
        num_bounding_boxes=4,
    )


def profiled_steps(steps: int, checkpoint_every: int) -> List[int]:
    """The 1-based steps profiled: the first from the fourth on and the last
    that neither end nor start an epoch. The step before each is the
    profiler's warm-up (on, its events dropped: device events right after
    a profiler starts can be lost), in the same epoch; the profiled step
    itself holds no metric fetch (the trainer fetches at an epoch's end)."""
    ok = [s for s in range(4, steps + 1) if s % checkpoint_every not in (0, 1)]
    return sorted({ok[0], ok[-1]}) if ok else []


def step_kernels(prof) -> Dict[str, int]:
    """The CUDA kernels and host-to-device copies in a profile of one step."""
    from torch.autograd import DeviceType

    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_device if e.name not in STEP_RANGES and not getattr(e, "is_user_annotation", False)
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    return {"kernels": len(kernels), "htod_copies": sum(1 for e in on_device if "htod" in e.name.lower())}


def soak_failures(rows: List[dict], steps: int, epoch_walls: List[float], time_tol: float,
                  epoch_launches: List[Dict[str, int]], step_profiles: List[Optional[Dict[str, int]]],
                  memory: List[Optional[Dict[str, int]]], ckpts: List[str], num_epochs: int,
                  lap_per_step: Optional[int] = None) -> tuple:
    """The soak's checks on what a run recorded: (failures, facts), where
    facts holds the loss means and windows and the steady median.

    `rows` are `metrics.jsonl`'s rows; `epoch_walls` each train epoch's
    seconds (`run_soak` gives them without the profiled steps); `epoch_launches` each epoch's rise of every kernel counter;
    `step_profiles` the profiled steps' counts (`step_kernels`, None off
    the card); `memory` each epoch's end allocation and peak (None off the
    card); `lap_per_step` the LAP launches a step must make (None off the
    card)."""
    failures: List[str] = []
    train_rows = [r for r in rows if r["split"] == "train"]
    if len(train_rows) != steps:
        failures.append(f"metrics.jsonl has {len(train_rows)} train rows (expected {steps})")
    if [r["step"] for r in train_rows] != list(range(1, steps + 1)):
        failures.append("metrics.jsonl steps are not contiguous 1..N")
    losses = np.array([r["loss"] for r in train_rows], np.float64)
    if not np.all(np.isfinite([v for r in train_rows for v in r.values() if isinstance(v, float)])):
        failures.append("non-finite loss component in metrics.jsonl")

    k = max(5, steps // 20)
    first_k, last_k = float(losses[:k].mean()), float(losses[-k:].mean())
    if not last_k < first_k:
        failures.append(f"loss did not decrease: first-{k} mean {first_k:.2f} vs last-{k} {last_k:.2f}")
    # monotone-ish: each fifth-of-the-run window no worse than the previous +2%,
    # only where each window averages enough steps to beat batch noise
    windows = [float(w.mean()) for w in np.array_split(losses, 5)]
    if steps >= 50:
        for a, b in zip(windows, windows[1:]):
            if b > a * 1.02:
                failures.append(f"loss window regressed: {a:.2f} -> {b:.2f} (windows {['%.1f' % w for w in windows]})")
                break

    # step-time stability: epoch 1 carries the warm-up; epochs 2..N within time_tol of their median
    steady = epoch_walls[1:]
    med = float(np.median(steady)) if steady else 0.0
    for i, w in enumerate(steady, start=2):
        if med and abs(w - med) > time_tol * med:
            failures.append(f"epoch {i} wall {w:.2f}s deviates >{time_tol:.0%} from median {med:.2f}s")

    # steady launches: every kernel counter rises by the same count each epoch
    if any(e != epoch_launches[0] for e in epoch_launches[1:]):
        failures.append(f"kernel launches differ between epochs: {epoch_launches}")
    if lap_per_step is not None:
        per_epoch = steps // max(num_epochs, 1)
        for i, e in enumerate(epoch_launches, start=1):
            if e.get("lap", 0) != lap_per_step * per_epoch:
                failures.append(f"epoch {i}: {e.get('lap', 0)} LAP launches (expected {lap_per_step * per_epoch})")
                break

    # one steady step: the early and the late profiled step launch the same kernels
    profiled = [p for p in step_profiles if p is not None]
    if len(profiled) == 2 and profiled[0]["kernels"] != profiled[1]["kernels"]:
        failures.append(f"kernels of a step changed: {profiled[0]['kernels']} early, {profiled[1]['kernels']} late")

    # memory: flat at the end of epochs 2..N, each later peak within PEAK_TOL of epoch 2's
    later = [m for m in memory[1:] if m is not None]
    if later:
        ends = [m["end_bytes"] for m in later]
        if max(ends) - min(ends) > MEMORY_TOL_BYTES:
            failures.append(f"allocated memory at the end of epochs 2..N moved by {max(ends) - min(ends)} bytes: {ends}")
        for i, m in enumerate(later[1:], start=3):
            if abs(m["peak_bytes"] - later[0]["peak_bytes"]) > PEAK_TOL * later[0]["peak_bytes"]:
                failures.append(f"epoch {i} peak {m['peak_bytes']} bytes vs epoch 2's {later[0]['peak_bytes']}")
                break

    if len(ckpts) != num_epochs:
        failures.append(f"expected {num_epochs} checkpoints, found {ckpts}")
    facts = {"losses": losses, "first_k": first_k, "last_k": last_k, "windows": windows, "steady": steady,
             "median_epoch_s": med}
    return failures, facts


def run_soak(steps: int = 200, batch: int = 8, pool: int = 4, checkpoint_every: int = 50,
             output_dir: Optional[str] = None, tiny: bool = False, ema: bool = True,
             time_tol: float = 0.35, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> dict:
    """Train `steps` bf16 steps over the cycled pool and check the run
    (`soak_failures`); returns the summary (`ok` is False on any failure)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from diffusiondrive_torch.device import resolve_device
    from diffusiondrive_torch.entry import build_model
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.ops import kernel_counters
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer

    if steps <= 0 or steps % checkpoint_every != 0:
        raise ValueError(
            f"--steps ({steps}) must be a positive multiple of "
            f"--checkpoint-every ({checkpoint_every})")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    config = tiny_soak_config() if tiny else TransfuserConfig()

    out = Path(output_dir or os.path.join(tempfile.gettempdir(), "dd_soak"))
    out.mkdir(parents=True, exist_ok=True)
    metrics_path = out / "metrics.jsonl"
    if metrics_path.exists():
        metrics_path.unlink()  # the integrity check wants this run only
    for stale in out.glob("epoch_*"):  # ditto the checkpoint count and restore
        shutil.rmtree(stale)

    model = build_model(config, torch.bfloat16, seed=seed).to(device)
    num_epochs = steps // checkpoint_every
    opt_cfg = OptimizerConfig(steps_per_epoch=checkpoint_every, epochs=num_epochs,
                              ema_decay=0.999 if ema else None)
    trainer = Trainer(model, config, opt_cfg, output_dir=str(out), seed=seed)

    # the pool goes to the device once; the trainer passes device tensors through
    device_pool = [trainer.to_device(b) for b in _make_batch_pool(config, batch, pool, seed)]

    counters = kernel_counters()
    epoch_walls: List[float] = []
    epoch_launches: List[Dict[str, int]] = []
    memory: List[Optional[Dict[str, int]]] = []

    def counts() -> Dict[str, int]:
        return {k: f.launches for k, f in counters.items()}

    class _EpochRecorder:
        def on_epoch_start(self, split, epoch):
            if split == "train":
                if cuda:
                    torch.cuda.synchronize(device)
                    torch.cuda.reset_peak_memory_stats(device)
                self._launches = counts()
                self._t0 = time.perf_counter()

        def on_epoch_end(self, split, epoch):
            if split == "train":   # the trainer has fetched the epoch's metrics: its steps are done
                epoch_walls.append(time.perf_counter() - self._t0)
                now = counts()
                epoch_launches.append({k: now[k] - self._launches[k] for k in now})
                memory.append({"end_bytes": torch.cuda.memory_allocated(device),
                               "peak_bytes": torch.cuda.max_memory_allocated(device)} if cuda else None)

    trainer.callbacks.append(_EpochRecorder())

    profiled = profiled_steps(steps, checkpoint_every)
    step_profiles: List[Dict] = []
    profiled_s = [0.0] * num_epochs   # wall of each epoch's warm-up and profiled steps, profiler included

    def train_batches(epoch: int):
        prof, t0 = None, 0.0
        for i in range(checkpoint_every):
            step = epoch * checkpoint_every + i + 1
            b = device_pool[(step - 1) % len(device_pool)]
            if cuda and step + 1 in profiled:   # the warm-up step
                t0 = time.perf_counter()
                torch.cuda.synchronize(device)
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                               schedule=schedule(wait=0, warmup=1, active=1),
                               on_trace_ready=lambda p: step_profiles.append(step_kernels(p)))
                prof.start()
            yield b   # the trainer runs this step before asking for the next batch
            if prof is not None:
                torch.cuda.synchronize(device)
                prof.step()
                if step in profiled:
                    prof.stop()
                    prof = None
                    profiled_s[epoch] += time.perf_counter() - t0

    t_start = time.perf_counter()
    trainer.fit(train_batches, num_epochs=num_epochs, log_every=checkpoint_every, checkpoint_every_epochs=1)
    wall = time.perf_counter() - t_start
    # an epoch's wall without its warm-up and profiled steps, as the wall of as many
    # unprofiled steps as the epoch has (the profiler's start, stop and trace take seconds)
    per_epoch = [2 * sum(1 for s in profiled if e * checkpoint_every < s <= (e + 1) * checkpoint_every)
                 for e in range(num_epochs)]
    steady_walls = [(w - p) * checkpoint_every / (checkpoint_every - k) if k else w
                    for w, p, k in zip(epoch_walls, profiled_s, per_epoch)]

    rows = [json.loads(line) for line in metrics_path.read_text().splitlines()]
    ckpts = sorted(p.name for p in out.glob("epoch_*"))
    failures, facts = soak_failures(rows, steps, steady_walls, time_tol, epoch_launches,
                                    step_profiles if cuda else [None, None], memory, ckpts, num_epochs,
                                    lap_per_step=1 if cuda else None)
    if len(ckpts) == num_epochs:
        trainer.restore_checkpoint(out / ckpts[-1])
        if int(trainer.state.step) != steps:
            failures.append(f"restored step {int(trainer.state.step)} != {steps}")
    if cuda and len(step_profiles) != 2:
        failures.append(f"profiled {len(step_profiles)} steps (expected 2)")

    losses, steady = facts["losses"], facts["steady"]
    summary = {
        "steps": steps, "batch": batch, "tiny": tiny, "ema": ema,
        "wall_s": round(wall, 2),
        "steady_ms_per_step": round(1000.0 * facts["median_epoch_s"] / checkpoint_every, 2) if steady else None,
        "epoch_walls_s": [round(w, 2) for w in epoch_walls],
        "epoch_walls_unprofiled_s": [round(w, 3) for w in steady_walls],
        "loss_first": round(float(losses[0]), 3), "loss_last": round(float(losses[-1]), 3),
        "loss_first_k": round(facts["first_k"], 3), "loss_last_k": round(facts["last_k"], 3),
        "loss_windows": [round(w, 2) for w in facts["windows"]],
        # JAX's compile count has no torch meaning: the CUDA kernels of the last (steady) step
        "compile_cache_size": step_profiles[-1]["kernels"] if cuda and step_profiles else None,
        "step_profiles": step_profiles if cuda else None,
        "htod_copies_per_step": step_profiles[-1]["htod_copies"] if cuda and step_profiles else None,
        "epoch_launches": epoch_launches,
        "memory_end_bytes": [m["end_bytes"] for m in memory] if cuda else None,
        "memory_peak_bytes": [m["peak_bytes"] for m in memory] if cuda else None,
        "checkpoints": ckpts,
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
        "ok": not failures, "failures": failures,
    }
    (out / "soak_summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--pool", type=int, default=4, help="distinct synthetic batches cycled")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--output-dir", default=None, help="default: dd_soak in the temp directory")
    parser.add_argument("--tiny", action="store_true", help="tiny model for CPU runs")
    parser.add_argument("--device", default=None, help="default: the current CUDA device; 'cpu' for the CPU")
    parser.add_argument("--no-ema", action="store_true")
    parser.add_argument("--time-tol", type=float, default=0.35)
    args = parser.parse_args(argv)
    summary = run_soak(steps=args.steps, batch=args.batch, pool=args.pool,
                       checkpoint_every=args.checkpoint_every, output_dir=args.output_dir,
                       tiny=args.tiny, ema=not args.no_ema, time_tol=args.time_tol, device=args.device)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
