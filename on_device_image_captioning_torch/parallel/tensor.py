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

Training runs through the same forms: each collective is an autograd
function paired with its conjugate (Megatron's f and g), so autograd meets
the other ranks too:

- row-parallel sum (`_SumRanks`): forward `all_reduce`, backward the
  identity (the gradient of a replicated output is the same on every rank);
- column-parallel input (`_CopyToRanks`, where a replicated activation
  enters a column or heads cut): forward the identity, backward the
  `all_reduce` of the input's gradient, whose ranks each hold the part that
  flowed through their columns;
- vocab gather (`_GatherColumns`): forward the zero-filled `all_reduce`,
  backward the rank's own columns of the whole (replicated) gradient;
- sharded embedding: the masked rows' `all_reduce` is a row-parallel sum,
  so each rank's table gets the gradient of its own rows only.

Every rank of a model group thus computes the same replicated activations
and gradients, bit for bit: the replicated weights stay equal across the
group without a collective of their own. The sums run in fp32; a gradient
leaves a backward `all_reduce` in its own dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _SumRanks(torch.autograd.Function):
    """Forward: the sum over the group's ranks. Backward: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToRanks(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the
    group's ranks in fp32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.float().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out.to(grad.dtype), None


class _GatherColumns(torch.autograd.Function):
    """Forward: whole rows (..., total) from the rank's columns y at
    [start, start + n), by the zero-filled `all_reduce`. Backward: the rank's
    columns of the gradient."""

    @staticmethod
    def forward(ctx, y, start, total, group):
        ctx.span = (start, y.shape[-1])
        buf = torch.zeros((*y.shape[:-1], total), dtype=y.dtype, device=y.device)
        buf[..., start:start + y.shape[-1]] = y
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        start, n = ctx.span
        return grad[..., start:start + n], None, None, None


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks, summed in fp32 (the row-parallel sum:
    its gradient passes through unchanged)."""
    return _SumRanks.apply(x.float(), group)


def copy_to_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is, whose gradient is summed over the group: where a
    replicated activation enters a column or heads cut."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToRanks.apply(x, group)
    return x


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
    dtype. Its gradient is the rank's columns of the whole rows' gradient."""
    return _GatherColumns.apply(y.float(), start, total, group).to(y.dtype)


class ShardedLinear(nn.Module):
    """A rank's slice of an `nn.Linear` (weight (out, in) as there).
    kind: "column" (weight rows and bias sliced, the rank's outputs),
    "row" (weight columns sliced, bias whole, outputs summed over the group)
    or "vocab" (column slices assembled into whole rows). `forward(x, dtype)`
    computes in `dtype` (x's when None), as `models/common.py::linear`.
    `start` and `total`: where the rank's output columns lie among the whole
    layer's (a "column" or "vocab" cut; a dropout on them draws the whole
    mask and keeps these columns). The weights are trainable where
    `requires_grad` says so (the layer's they replace)."""

    KINDS = ("column", "row", "vocab")

    def __init__(self, kind: str, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group, start: int = 0, total: int = 0, requires_grad: bool = False):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"ShardedLinear kind {kind!r}; expected one of {self.KINDS}")
        self.kind, self.group, self.start, self.total = kind, group, start, total
        self.weight = nn.Parameter(weight.detach().clone(), requires_grad=requires_grad)
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(),
                                                           requires_grad=requires_grad)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if dtype is not None:
            x = x.to(dtype)
        if self.kind == "row":
            return row_linear(x, self.weight, self.bias, self.group)
        y = column_linear(copy_to_ranks(x, self.group), self.weight, self.bias)
        if self.kind == "vocab":
            y = gather_columns(y, self.start, self.total, self.group)
        return y

    def extra_repr(self) -> str:
        return f"kind={self.kind}, weight={tuple(self.weight.shape)}"


class ShardedEmbedding(nn.Module):
    """A rank's rows [start, start + n) of a (vocab, d) embedding table."""

    def __init__(self, weight: torch.Tensor, start: int, vocab: int, group,
                 requires_grad: bool = False):
        super().__init__()
        self.start, self.vocab, self.group = start, vocab, group
        self.weight = nn.Parameter(weight.detach().clone(), requires_grad=requires_grad)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return vocab_embedding(ids, self.weight, self.start, self.vocab, self.group)

    def extra_repr(self) -> str:
        return f"rows={self.start}:{self.start + self.weight.shape[0]} of {self.vocab}"
