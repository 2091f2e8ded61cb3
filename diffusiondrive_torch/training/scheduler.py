"""Learning-rate schedule (counterpart of `diffusiondrive_tpu/training/scheduler.py`).

WarmupCosLR as a plain function of the optimiser step: linear warm-up over
`warmup_epochs`, then a cosine decay to `min_lr` across `epochs`. The
optimiser uses it through `torch.optim.lr_scheduler.LambdaLR`, one lambda
per parameter group (`training/train.py:build_optimizer`).
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cos_lr(lr: float, min_lr: float, epochs: int, warmup_epochs: int,
                  steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The learning rate at a step: per-epoch granularity when
    `steps_per_epoch` is 1, a smooth per-step interpolation otherwise."""
    warmup_steps = warmup_epochs * steps_per_epoch
    total_steps = epochs * steps_per_epoch

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * (step + 1) / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * progress))

    return schedule
