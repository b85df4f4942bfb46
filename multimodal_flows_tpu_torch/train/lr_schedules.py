"""Learning-rate schedule (port of `multimodal_flows_tpu/train/lr_schedules.py`):
linear warmup from 1% of `lr` over `warmup_epochs`, then cosine from `lr`
to `lr_final` over the remaining epochs, as a per-epoch staircase over the
global step."""

from __future__ import annotations

import math


def warmup_cosine_epoch_schedule(lr: float, lr_final: float, warmup_epochs: int,
                                 max_epochs: int, steps_per_epoch: int):
    """A function of the global step (an int) returning the learning rate."""
    cosine_epochs = max(max_epochs - warmup_epochs, 1)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < warmup_epochs:
            return lr * (0.01 + (1.0 - 0.01) * min(max(epoch / warmup_epochs, 0.0), 1.0))
        e = min(max(epoch - warmup_epochs, 0), cosine_epochs)
        return lr_final + 0.5 * (lr - lr_final) * (1.0 + math.cos(math.pi * e / cosine_epochs))

    return schedule
