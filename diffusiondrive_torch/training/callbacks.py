"""Training callbacks (counterpart of `diffusiondrive_tpu/training/callbacks.py`).

Callbacks hook into the trainer's epoch loop. The BEV visualisation
callback waits for the port's visualisation module.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

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
