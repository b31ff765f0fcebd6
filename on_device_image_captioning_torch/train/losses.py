"""Training losses (counterpart of the JAX package's `train/losses.py`).

The label-smoothing loss follows the reference (losses/loss.py:5-39): the KL
divergence between the log-softmaxed predictions and a smoothed one-hot whose
uniform mass is smoothing / (V - 1), with PAD target positions zeroed and the
sum divided by the number of non-pad tokens.
"""
from __future__ import annotations

import math

import torch


def label_smoothing_loss(
    logits: torch.Tensor, targets: torch.Tensor, pad_idx: int, smoothing: float = 0.1,
    divide_by_non_pads: bool = True,
) -> torch.Tensor:
    """logits (B, T, V) before the softmax; targets (B, T) ids. Computed
    without the (B, T, V) one-hot: with u = smoothing / (V - 1) on every class
    and c = 1 - smoothing on the target class,
    sum_v q_v logp_v = u sum_v logp_v + (c - u) logp_target."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    u = smoothing / (v - 1)
    c = 1.0 - smoothing
    tgt_logp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    cross = u * logp.sum(dim=-1) + (c - u) * tgt_logp
    # sum_v q_v log q_v: constant in the parameters, kept for the loss's value
    ent = (v - 1) * u * math.log(max(u, 1e-30)) + c * math.log(max(c, 1e-30))
    non_pad = targets != pad_idx
    total = torch.where(non_pad, ent - cross, 0.0).sum()
    if divide_by_non_pads:
        return total / non_pad.sum().clamp_min(1)
    return total


def scst_loss(
    sample_logprobs: torch.Tensor, rewards: torch.Tensor, baselines: torch.Tensor
) -> torch.Tensor:
    """REINFORCE with a baseline (reference losses/reward.py:87-89): the mean
    over (B, num_samples) of (r - b) * sum_t(-logp_t). sample_logprobs
    (B, N, T) are zero after EOS; rewards and baselines (B, N)."""
    return ((rewards - baselines) * (-sample_logprobs).sum(dim=-1)).mean()


def mean_baseline(rewards: torch.Tensor) -> torch.Tensor:
    """Leave-one-out mean of the other samples' rewards (B, N)."""
    n = rewards.shape[-1]
    return (rewards.sum(dim=-1, keepdim=True) - rewards) / (n - 1)
