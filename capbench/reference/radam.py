"""Plain RAdam (Liu et al., arXiv:1908.03265) as the reference repository's
optims/radam.py applies it, without the SGD fallback: below an SMA length
of 5 it takes no step. The learning rate follows the recipe's
custom_warmup_anneal schedule, read at the count of steps taken; the
optimizer may resume at a count with empty moments, or from a state
({"mu": {leaf: moment}, "nu": {...}, "count": steps taken}).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def custom_warmup_anneal(c: Dict, step: int) -> float:
    gate = c["min_lr"] if step >= c["warmup_iters"] else 0.0
    ramp = c["lr"] / max(c["warmup_iters"] - step, 1.0)
    decay = c["anneal_coeff"] ** math.floor(step / (c["num_batches"] * c["anneal_every_epoch"]))
    return max(gate, ramp * decay)


class RAdam:
    def __init__(self, params: Dict[str, torch.Tensor], c: Dict, state: Optional[Dict] = None):
        if c["kind"] != "radam" or c["schedule"] != "custom_warmup_anneal":
            raise ValueError(f"the reference has RAdam with custom_warmup_anneal, not {c}")
        self.params, self.c = params, c
        if state is None:
            self.count = int(c.get("resume_count", 0))
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        else:
            self.count = int(state["count"])
            self.mu = {k: state["mu"][k].clone() for k in params}
            self.nu = {k: state["nu"][k].clone() for k in params}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        c = self.c
        lr = custom_warmup_anneal(c, self.count)
        self.count += 1
        t, b1, b2 = self.count, c["b1"], c["b2"]
        sma_max = 2 / (1 - b2) - 1
        sma = sma_max - 2 * t * b2**t / (1 - b2**t)
        for k, g in grads.items():
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            if sma >= 5:
                r = math.sqrt((1 - b2**t) * (sma - 4) / (sma_max - 4) * (sma - 2) / sma
                              * sma_max / (sma_max - 2)) / (1 - b1**t)
                self.params[k] -= lr * r * self.mu[k] / (self.nu[k].sqrt() + c["eps"])
