"""The seed's weights: every parameter of the model drawn on the device in
three calls, named as the reference repository names them. The program is
loaded with them and the reference is handed the same tensors; neither side
makes them.
"""
from __future__ import annotations

from typing import Dict

import torch


def weight_kinds(named_shapes):
    """name -> kind of every parameter: "norm_w", "bias", "swin_w" (a
    backbone matrix or table) or "head_w" (a caption-head matrix or table).
    A norm is recognised by its name (the reference repo's names)."""
    kinds = {}
    for name, shape in named_shapes:
        owner, _, leaf = name.rpartition(".")
        last = owner.rpartition(".")[2]
        is_norm = last.startswith("norm") or last.endswith("_norm")
        if is_norm:
            kinds[name] = "norm_w" if leaf == "weight" else "bias"
        elif len(shape) < 2:
            kinds[name] = "bias"
        else:
            kinds[name] = "swin_w" if name.startswith("swin_transf.") else "head_w"
    return kinds


@torch.no_grad()
def draw_weights(named_shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, fp32, drawn on `device` from the seed in three calls
    (the distributions are in the configuration files' `assumed`). The same
    seed on the same kind of device gives the same weights; the reference is
    handed these same tensors."""
    named_shapes = list(named_shapes)
    kinds = weight_kinds(named_shapes)
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = {name: int(torch.Size(shape).numel()) for name, shape in named_shapes}
    n_normal = sum(sizes[n] for n, _ in named_shapes if kinds[n] in ("swin_w", "bias"))
    n_uniform = sum(sizes[n] for n, _ in named_shapes if kinds[n] in ("head_w", "norm_w"))
    normal = torch.randn(n_normal, generator=g, device=device).mul_(0.02).clamp_(-0.04, 0.04)
    uniform = torch.rand(n_uniform, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, i, j = {}, 0, 0
    for name, shape in named_shapes:
        k, n = kinds[name], sizes[name]
        if k in ("swin_w", "bias"):
            t = normal[i:i + n]
            i += n
        else:
            t = uniform[j:j + n]
            j += n
            if k == "norm_w":
                t = 1.0 + 0.1 * t
            else:
                fan_out, fan_in = shape[0], int(torch.Size(shape[1:]).numel())
                t = t * (6.0 / (fan_in + fan_out)) ** 0.5
        out[name] = t.view(shape)
    return out
