"""Training callbacks (counterpart of `diffusiondrive_tpu/training/callbacks.py`).

Callbacks hook into the trainer's epoch loop: the epoch wall time, and the
BEV visualisation tiles of the first validation batch (host code; the
trainer hands it the batch and the eval outputs as numpy, on rank 0).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)


class TimeLoggingCallback:
    """Logs each epoch's wall time (train and val)."""

    def __init__(self) -> None:
        self._start: Dict[str, float] = {}

    def on_epoch_start(self, phase: str, epoch: int) -> None:
        self._start[phase] = time.perf_counter()

    def on_epoch_end(self, phase: str, epoch: int) -> None:
        elapsed = time.perf_counter() - self._start.get(phase, time.perf_counter())
        logger.info("[%s] epoch %d wall time: %.1fs", phase, epoch, elapsed)


class BEVVisualizationCallback:
    """Dumps camera / BEV-semantic GT-vs-pred tiles once per epoch."""

    def __init__(self, output_dir: str, max_samples: int = 4):
        self._output_dir = Path(output_dir)
        self._max_samples = max_samples

    def on_validation_batch(self, epoch: int, batch: Dict[str, np.ndarray],
                            outputs: Dict[str, np.ndarray], batch_idx: int = 0) -> None:
        if batch_idx != 0:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from diffusiondrive_torch.visualization.plots import plot_bev_semantic_comparison

        out_dir = self._output_dir / f"epoch_{epoch:04d}"
        out_dir.mkdir(parents=True, exist_ok=True)
        n = min(self._max_samples, len(batch["bev_semantic_map"]))
        for i in range(n):
            fig, _ = plot_bev_semantic_comparison(
                np.asarray(batch["bev_semantic_map"][i]),
                np.asarray(outputs["bev_semantic_map"][i]),
            )
            fig.savefig(out_dir / f"bev_semantic_{i}.png", dpi=80)
            plt.close(fig)

        if "camera_feature" in batch:
            for i in range(n):
                img = np.asarray(batch["camera_feature"][i])
                if img.dtype != np.uint8:  # float [0, 1] fixtures
                    img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
                plt.imsave(out_dir / f"camera_{i}.png", img)
        logger.info("wrote %d visualization tiles to %s", n, out_dir)
