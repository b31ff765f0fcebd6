"""RAdam as `torch.optim.Optimizer`s (counterpart of the JAX package's
`train/radam.py`, which rebuilds the reference's optims/radam.py).

Semantics kept, step for step:

- the rectified step applies only when the SMA length N_sma >= 5;
- below that, `degenerated_to_sgd=True` (`PlainRAdam`) takes a bias-corrected
  momentum step, False (`RAdam`, the reference's default) takes no step;
- weight decay is `p -= wd * lr * p` inside the gated branches;
- `lr` is a float or a schedule step -> lr (`train/schedules.py`), read at
  the count of steps taken before this one. The count travels with
  `state_dict()`, so a resumed optimizer continues its schedule and its
  rectification where it stopped.

Moments are kept in each parameter's dtype (fp32 master weights).
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch


class RAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: Union[float, Callable[[int], float]], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 degenerated_to_sgd: bool = False):
        # a schedule is kept beside the groups: a group's "lr" must be a
        # number for the base class, and holds the last lr used
        self.schedule = lr if callable(lr) else None
        defaults = dict(lr=0.0 if callable(lr) else float(lr), b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, degenerated_to_sgd=degenerated_to_sgd)
        super().__init__(params, defaults)
        self.count = 0  # steps taken

    def state_dict(self) -> dict:
        """The base class's state plus the count of steps taken, which the
        schedule and the bias corrections read (the JAX state's `count`)."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count", 0))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        step_lr = None if self.schedule is None else float(self.schedule(self.count))
        self.count += 1
        t = float(self.count)
        for group in self.param_groups:
            if step_lr is not None:
                group["lr"] = step_lr
            lr, b1, b2, wd = group["lr"], group["b1"], group["b2"], group["weight_decay"]
            beta2_t = b2**t
            n_sma_max = 2.0 / (1.0 - b2) - 1.0
            n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
            use_rect = n_sma >= 5.0
            if use_rect:
                rect = math.sqrt(
                    (1.0 - beta2_t) * (n_sma - 4.0) / (n_sma_max - 4.0) * (n_sma - 2.0) / n_sma
                    * n_sma_max / (n_sma_max - 2.0)) / (1.0 - b1**t)
            momentum_step = 1.0 / (1.0 - b1**t)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu, nu, g = state["mu"], state["nu"], p.grad
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                if use_rect:
                    if wd:
                        p.mul_(1.0 - wd * lr)
                    p.addcdiv_(mu, nu.sqrt().add_(group["eps"]), value=-rect * lr)
                elif group["degenerated_to_sgd"]:
                    if wd:
                        p.mul_(1.0 - wd * lr)
                    p.add_(mu, alpha=-momentum_step * lr)
        return loss


class PlainRAdam(RAdam):
    """`RAdam` with `degenerated_to_sgd=True` (reference optims/radam.py:140-237)."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, b1, b2, eps, weight_decay, degenerated_to_sgd=True)
