"""Tensor parallelism over a model axis, written out on tensors: the work that
XLA's SPMD partitioner does for the JAX package once `parallel/mesh.py::
_MODEL_AXIS_RULES` there has placed the weights (Megatron-style sharding).

Each rank of a model group holds a slice of a layer's weight
(`parallel/mesh.py::shard_model` cuts it) and the layer meets the other
ranks' slices through `all_reduce` alone:

- column-parallel linear: the rank's output columns, no collective (the
  next layer takes them as they are);
- row-parallel linear: the rank's partial sums over its input columns, their
  `all_reduce` in fp32, then the bias once;
- vocab-parallel embedding: the rank's rows of the table, zeros for the ids
  outside them, `all_reduce`; ids outside the vocabulary are clamped first,
  as `models/common.py::embedding` (and `jnp.take(mode="clip")`) does;
- vocab-parallel logits: a column-parallel product whose slices are
  assembled into whole rows by an `all_reduce` of a zero-filled (rows, V)
  buffer into which each rank writes its slice (adding zeros is exact), so
  `log_softmax` and the top-k kernel K3 run on whole rows.

Only `all_reduce` is used: it is the one reduction the gloo backend offers on
CUDA tensors as well as on CPU ones, so two ranks on one card (gloo) and one
rank a card (NCCL) run the same code. The module forms below are what
`shard_model` puts in the place of an `nn.Linear` or `nn.Embedding`;
`models/common.py::linear` and `embedding` dispatch on them, so every call
site keeps its form.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks, summed in fp32."""
    out = x.float().contiguous()
    dist.all_reduce(out, group=group)
    return out


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]):
    """The rank's output columns of x W^T + b: weight (out / n, in)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], group):
    """x W^T + b from the rank's input columns x (..., in / n) and weight
    (out, in / n): the partial products summed over the group in fp32, the
    bias added once, the result in x's dtype."""
    y = _all_reduce_f32(F.linear(x, weight.to(x.dtype)), group)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def vocab_embedding(ids: torch.Tensor, table: torch.Tensor, start: int, vocab: int, group):
    """Rows of the whole (vocab, d) table from the rank's rows [start, start +
    table.shape[0]): ids clamped to the vocabulary, the rank's hits looked up,
    the rest zeros, summed over the group (one rank holds each row)."""
    ids = ids.long().clamp(0, vocab - 1) - start
    hit = (ids >= 0) & (ids < table.shape[0])
    rows = F.embedding(torch.where(hit, ids, 0), table)
    return _all_reduce_f32(rows * hit[..., None], group).to(table.dtype)


def gather_columns(y: torch.Tensor, start: int, total: int, group) -> torch.Tensor:
    """Whole rows (..., total) from the rank's columns y (..., n) at [start,
    start + n): a zero-filled buffer with the rank's slice written in,
    summed over the group in fp32 (exact: every other term is zero), in y's
    dtype."""
    buf = torch.zeros((*y.shape[:-1], total), dtype=torch.float32, device=y.device)
    buf[..., start:start + y.shape[-1]] = y
    dist.all_reduce(buf, group=group)
    return buf.to(y.dtype)


class ShardedLinear(nn.Module):
    """A rank's slice of an `nn.Linear` (weight (out, in) as there).
    kind: "column" (weight rows and bias sliced, the rank's outputs),
    "row" (weight columns sliced, bias whole, outputs summed over the group)
    or "vocab" (column slices assembled into whole rows). `forward(x, dtype)`
    computes in `dtype` (x's when None), as `models/common.py::linear`."""

    KINDS = ("column", "row", "vocab")

    def __init__(self, kind: str, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group, start: int = 0, total: int = 0):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"ShardedLinear kind {kind!r}; expected one of {self.KINDS}")
        self.kind, self.group, self.start, self.total = kind, group, start, total
        self.weight = nn.Parameter(weight.detach().clone(), requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(),
                                                           requires_grad=False)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if dtype is not None:
            x = x.to(dtype)
        if self.kind == "row":
            return row_linear(x, self.weight, self.bias, self.group)
        y = column_linear(x, self.weight, self.bias)
        if self.kind == "vocab":
            y = gather_columns(y, self.start, self.total, self.group)
        return y

    def extra_repr(self) -> str:
        return f"kind={self.kind}, weight={tuple(self.weight.shape)}"


class ShardedEmbedding(nn.Module):
    """A rank's rows [start, start + n) of a (vocab, d) embedding table."""

    def __init__(self, weight: torch.Tensor, start: int, vocab: int, group):
        super().__init__()
        self.start, self.vocab, self.group = start, vocab, group
        self.weight = nn.Parameter(weight.detach().clone(), requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return vocab_embedding(ids, self.weight, self.start, self.vocab, self.group)

    def extra_repr(self) -> str:
        return f"rows={self.start}:{self.start + self.weight.shape[0]} of {self.vocab}"
