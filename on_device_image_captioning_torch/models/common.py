"""Shared building blocks: linear, LayerNorm, embedding, dropout and the
stochastic-depth scale on plain tensors.

Weights are stored as in torch (`nn.Linear.weight` is (out, in)) and kept in
float32; `dtype` selects the compute dtype of the matmul path, as `linear(p,
x, dtype)` does in the JAX package. LayerNorm always computes its statistics
in float32 and dispatches to `ops/layernorm.py` (kernel K4 on CUDA tensors).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..deploy.quantization import QuantLinear
from ..parallel.tensor import ShardedEmbedding, ShardedLinear
from ..ops.layernorm import layernorm as _layernorm_op
from ..ops.layernorm import layernorm_autograd as _layernorm_autograd
from ..utils.profiling import count, tracing


def linear(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """y = x W^T + b in `dtype` (x's dtype when None); the result keeps the
    compute dtype, as the JAX package's `linear` does. A `QuantLinear` ignores
    `dtype` and returns fp32; a `ShardedLinear` (tensor parallelism,
    `parallel/tensor.py`) computes its rank's part and meets the others'."""
    if isinstance(layer, QuantLinear):
        return layer(x)
    if isinstance(layer, ShardedLinear):
        return layer(x, dtype)
    if dtype is not None:
        x = x.to(dtype)
    w, b = layer.weight, layer.bias
    dt = x.dtype
    cast_w = w.dtype != dt
    cast_b = b is not None and b.dtype != dt
    if cast_w or cast_b:
        if tracing():
            count("weight_cast", cast_w + cast_b,
                  nbytes=(w.nbytes if cast_w else 0) + (b.nbytes if cast_b else 0))
        w = w.to(dt)
        b = None if b is None else b.to(dt)
    return F.linear(x, w, b)


def layernorm(norm: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.LayerNorm over the last dim (biased variance), statistics in
    fp32, output in x's dtype. Where a gradient is being recorded the call
    goes through the autograd function (same forward, plain backward)."""
    if torch.is_grad_enabled() and (x.requires_grad or norm.weight.requires_grad):
        return _layernorm_autograd(x.contiguous(), norm.weight, norm.bias, eps)
    return _layernorm_op(x.contiguous(), norm.weight, norm.bias, eps)


def embedding(embed: nn.Module, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup in an `nn.Embedding` that CLAMPS out-of-range ids, as
    `jnp.take(..., mode="clip")` does in the JAX package (F.embedding raises
    instead, and on CUDA that is a device-side assert); a `ShardedEmbedding`
    clamps too and assembles the row from the ranks' slices."""
    if isinstance(embed, ShardedEmbedding):
        return embed(ids)
    table = embed.weight
    return F.embedding(ids.long().clamp(0, table.shape[0] - 1), table)


def f32_einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """einsum of the operands upcast to fp32: the counterpart of JAX's
    `preferred_element_type=jnp.float32` on bf16 inputs (bf16 values are
    exact in fp32, so this is an fp32-accumulated product of them)."""
    return torch.einsum(equation, *(t.float() for t in operands))


def _check_generator(what: str, generator: torch.Generator, device: torch.device) -> None:
    if generator.device.type != device.type:
        raise ValueError(
            f"{what}: the generator lives on {generator.device.type!r} and the tensors on "
            f"{device.type!r}; make it with torch.Generator(device=...) on the model's device")


def dropout(
    x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator] = None,
    cut: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Inverted dropout, as the JAX package's `dropout`: the identity when not
    training, at rate 0, or without a generator (its `rng is None`). The mask
    is drawn from the explicit generator, which must live on x's kind of
    device (no mask drawn on the host for a tensor on the card); no global
    seed is read.

    cut = (dim, start, whole): x holds positions [start, start + x.shape[dim])
    of an activation `whole` wide along dim (a rank's columns or heads under
    tensor parallelism, `column_cut`). The whole mask is drawn, as one
    process draws it, and the rank's part kept: the mask and every later draw
    of the generator's stream are one process's."""
    if not train or rate == 0.0 or generator is None:
        return x
    _check_generator("dropout", generator, x.device)
    keep = 1.0 - rate
    shape = list(x.shape)
    if cut is not None:
        shape[cut[0]] = cut[2]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if cut is not None:
        mask = mask.narrow(cut[0], cut[1], x.shape[cut[0]])
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def column_cut(layer: nn.Module) -> Optional[Tuple[int, int, int]]:
    """The `dropout` cut of a layer's output: the rank's columns of a
    column-parallel `ShardedLinear`, None for a whole layer."""
    if isinstance(layer, ShardedLinear) and layer.kind == "column":
        return (-1, layer.start, layer.total)
    return None


def drop_path_scale(
    rate: float, batch: int, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """Per-image stochastic-depth multiplier (B,) fp32: 1 / keep with
    probability keep, else 0 (`dp_scale` of the JAX training runner); ones
    without a generator or at rate 0. The generator must live on `device`'s
    kind of device."""
    if generator is None or rate == 0.0:
        return torch.ones((batch,), dtype=torch.float32, device=device)
    _check_generator("drop_path_scale", generator, torch.device(device))
    keep = 1.0 - rate
    kept = torch.rand((batch,), generator=generator, device=device) < keep
    return torch.where(kept, 1.0 / keep, 0.0).to(torch.float32)
