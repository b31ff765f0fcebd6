"""The cross-entropy (XE) training step (counterpart of `make_xe_step` and
`with_grad_accum` in the JAX package's `train/train_step.py`).

XE: model(images, dec_x = y[:, :-1]) against the targets y[:, 1:] under the
label-smoothing loss, gradients of every parameter, one optimizer update
(reference train.py:107-123). Gradient accumulation applies the optimizer
every `num_accum` micro-steps on the mean of their gradients
(train.py:174-176; `optax.MultiSteps` in the JAX package).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import ModelConfig
from ..utils.image import normalize_on_device
from .losses import label_smoothing_loss


def xe_loss(model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, smoothing: float = 0.1,
            drop_path_scales=None) -> torch.Tensor:
    """The XE loss of one batch, differentiable in the model's parameters.
    batch: 'enc_input' images NHWC (uint8, normalized here, or already
    normalized floats) and 'captions' (B, T) ids right-padded with PAD; the
    decoder input / target split happens here."""
    cap = cfg.captioner
    images, captions = batch["enc_input"], batch["captions"]
    if images.dtype == torch.uint8:
        images = normalize_on_device(images)
    dec_input, targets = captions[:, :-1], captions[:, 1:]
    dec_pads = (dec_input == cap.pad_idx).sum(dim=-1)
    logits = model(images, dec_input, dec_pads, train=True, generator=generator,
                   drop_path_scales=drop_path_scales)
    return label_smoothing_loss(logits, targets, cap.pad_idx, smoothing)


def make_xe_step(model, cfg: ModelConfig, optimizer, smoothing: float = 0.1) -> Callable:
    """step(batch, generator=None, drop_path_scales=None) -> {'loss': tensor}:
    one forward with dropout and stochastic depth drawn from `generator` (off
    without one; `drop_path_scales` hands the per-block scales in instead),
    one backward, one `optimizer.step()`. The model's parameters are updated
    in place; the loss is returned detached, on the model's device."""

    def step(batch, generator=None, drop_path_scales=None):
        optimizer.zero_grad(set_to_none=True)
        loss = xe_loss(model, cfg, batch, generator, smoothing, drop_path_scales)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


class _EveryK:
    """An optimizer applied every k micro-steps on the mean of their
    gradients; between updates the gradients keep summing in `.grad`."""

    def __init__(self, optimizer, k: int):
        self.optimizer, self.k, self.micro = optimizer, k, 0
        self.param_groups = optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self.micro == 0:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.micro += 1
        if self.micro < self.k:
            return
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.div_(self.k)
        self.optimizer.step()
        self.micro = 0


def with_grad_accum(optimizer, num_accum: int):
    """The optimizer applied every `num_accum` micro-steps (itself when
    num_accum <= 1)."""
    return optimizer if num_accum <= 1 else _EveryK(optimizer, num_accum)
