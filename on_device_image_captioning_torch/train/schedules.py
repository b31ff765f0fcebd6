"""Learning-rate schedules: step -> absolute lr, as plain Python functions
(counterpart of the JAX package's `train/schedules.py`; the reference drives
a LambdaLR over base_lr = 1.0 with these two lambdas, train.py:503-528),
and `Scheduled`, which drives a torch optimizer's learning rate by one of
them (the JAX package's `optax.adam(schedule)` / `optax.adamw(schedule)`)."""
from __future__ import annotations

import math
from typing import Callable

import torch


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


class Scheduled:
    """A `torch.optim.Optimizer` whose learning rate follows `schedule` over
    its applied updates: update k (from 0) runs at lr = schedule(k), as
    optax's `scale_by_learning_rate(schedule)` counts them. `state_dict`
    carries the count beside the optimizer's own state."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.optimizer, self.schedule, self.count = optimizer, schedule, 0

    @property
    def param_groups(self):  # the optimizer's own: load_state_dict replaces them
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        lr = float(self.schedule(self.count))
        for group in self.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def adam(params, schedule: Callable[[int], float], weight_decay: float = 0.0) -> Scheduled:
    """optax.adam(schedule), or optax.adamw(schedule) with `weight_decay`
    (optax's default 1e-4 there, not torch's 1e-2): betas 0.9 / 0.999, eps
    1e-8, the decay decoupled (p -= lr * wd * p)."""
    if weight_decay:
        opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    return Scheduled(opt, schedule)
