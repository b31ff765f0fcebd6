"""Learning-rate schedules: step -> absolute lr, as plain Python functions
(counterpart of the JAX package's `train/schedules.py`; the reference drives
a LambdaLR over base_lr = 1.0 with these two lambdas, train.py:503-528)."""
from __future__ import annotations

import math
from typing import Callable


def annealing(
    lr: float, warmup_iters: int, anneal_every_epoch: float, num_batches: int,
    anneal_coeff: float = 0.8,
) -> Callable[[int], float]:
    """(min(it, warmup) / warmup) * lr * coeff^(it // (anneal_every_epoch * num_batches))."""

    def schedule(step: int) -> float:
        warm = min(step, warmup_iters) / warmup_iters
        decay = anneal_coeff ** math.floor(step / (anneal_every_epoch * num_batches))
        return warm * lr * decay

    return schedule


def custom_warmup_anneal(
    lr: float, warmup_iters: int, min_lr: float, anneal_coeff: float,
    anneal_every_epoch: float, num_batches: int,
) -> Callable[[int], float]:
    """max((it >= warmup) * min_lr,
    (lr / max(warmup - it, 1)) * coeff^(it // (num_batches * anneal_every_epoch)))."""

    def schedule(step: int) -> float:
        gate = min_lr if step >= warmup_iters else 0.0
        ramp = lr / max(warmup_iters - step, 1.0)
        decay = anneal_coeff ** math.floor(step / (num_batches * anneal_every_epoch))
        return max(gate, ramp * decay)

    return schedule
