"""Row LayerNorm over the last axis: kernel K4 (`csrc/layernorm.cu`) and its
plain version.

Replaces `on_device_image_captioning_tpu/ops/layernorm.py::layernorm_pallas`:
the kernel is the forward; as there, the gradient (`layernorm_autograd`) is
the plain formula from the saved (x, scale), on either device.

Bound and design: see the header of `csrc/layernorm.cu` (bytes at the
backbone's row counts, the launch at the decode's; a group of lanes a row,
the row in registers, both sums warp shuffles). `layernorm_plan` picks the
kernel's instance and grid from the shapes and the card's SM count; the
wrapper's own host work is kept small, because at the decode's (24, 512)
calls it is the time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List

import torch

from . import _build
from .linear_plan import sm_count

launches = 0  # kernel launches since the last reset (plain-version calls do not count)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/layernorm.cu: threads a CTA, CTAs an SM (its launch bounds), and the
# 16-byte chunks a lane may hold, one kernel instance each (0: any width)
THREADS = 256
CTAS_PER_SM = 2
LANE_CHUNKS = (1, 2, 3, 4, 6, 8, 12, 16, 24)
GROUPS = (32, 16, 8, 4, 2, 1)  # lanes a row, widest first


def layernorm_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """torch.nn.LayerNorm semantics with fp32 statistics; output in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerNormPlan:
    group: int  # lanes of a warp a row takes (32 / group rows a warp at once)
    lane_chunks: int  # 16-byte chunks a lane holds (0: the any-width kernel, a value at a time)
    ctas: int  # CTAs of the grid; the warps walk the rows with a grid-wide stride

    def rows_of(self, cta: int, warp: int, rows: int) -> List[int]:
        """The rows warp `warp` of CTA `cta` normalizes (its first row group
        at warp x ctas + cta, numbered CTA first, then a grid-wide stride):
        the lane-group rows of each group it walks."""
        per_warp = 32 // self.group
        stride = self.ctas * THREADS // 32 * per_warp
        start = (warp * self.ctas + cta) * per_warp
        return [r for r0 in range(start, rows, stride) for r in range(r0, min(r0 + per_warp, rows))]


@functools.lru_cache(maxsize=1024)
def layernorm_plan(rows: int, c: int, dtype: torch.dtype, sms: int,
                   aligned: bool = True) -> LayerNormPlan:
    """K4's launch for `rows` rows of width `c` in `dtype` on a card of `sms`
    SMs. A row of whole 16-byte chunks, with every operand 16-byte aligned,
    takes the widest lane group whose lanes hold it in a count of chunks the
    kernel has an instance for (C = 192 bf16: 24 chunks, 8 lanes of 3); else
    32 lanes of the fewest chunks that hold it; else (no whole chunks, not
    aligned, or wider than 32 x 24 chunks) the any-width kernel, a warp a row.
    The grid: a CTA for each group of rows a warp takes, at most CTAS_PER_SM
    an SM."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"layernorm: unsupported dtype {dtype}")
    if rows <= 0 or c <= 0 or sms <= 0:
        raise ValueError(f"layernorm: no launch for rows={rows} c={c} sms={sms}")
    itemsize = dtype.itemsize
    group, lane_chunks = 32, 0
    if aligned and (c * itemsize) % 16 == 0:
        chunks = c * itemsize // 16
        exact = [(g, chunks // g) for g in GROUPS
                 if chunks % g == 0 and chunks // g in LANE_CHUNKS]
        ragged = [n for n in LANE_CHUNKS if 32 * n >= chunks]
        if exact:
            group, lane_chunks = exact[0]
        elif ragged:
            lane_chunks = ragged[0]
    # warps are numbered CTA first, so a call of few rows spreads over as
    # many SMs as it has row groups
    return LayerNormPlan(group, lane_chunks, min(-(-rows // (32 // group)), CTAS_PER_SM * sms))


@functools.cache
def _launcher():
    return _build.cuda_function("layernorm", "layernorm_launch", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ))


def _layernorm_cuda(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """K4 on CUDA tensors: the CUDA kernel of `odic::layernorm`."""
    global launches
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise ValueError(f"layernorm: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("layernorm: weight/bias must have shape (C,)")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("layernorm: weight and bias must be float32")
    _build.check_cuda_tensors(x, weight, bias)
    out = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return out
    ptrs = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr())
    aligned = (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16 == 0
    plan = layernorm_plan(rows, c, x.dtype, sm_count(x.device), aligned)
    status = _launcher()(*ptrs, rows, c, plan.group, plan.lane_chunks, plan.ctas, eps, code,
                         _build.current_stream())
    _build.check_status(status, "layernorm")
    launches += 1
    return out


_op = _build.define_op(
    "layernorm", "(Tensor x, Tensor weight, Tensor bias, float eps) -> Tensor",
    layernorm_reference, _layernorm_cuda, lambda x, weight, bias, eps: x.new_empty(x.shape))


def layernorm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape): `odic::layernorm`,
    whose CPU kernel is the plain version and whose CUDA kernel is K4."""
    return _op(x, weight, bias, eps)


class _LayerNorm(torch.autograd.Function):
    """`layernorm` with the gradient of `layernorm_pallas` (its `_bwd`): the
    forward is the kernel on CUDA tensors, the backward plain tensor code in
    fp32 from the saved x and scale."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layernorm(x.detach(), weight.detach(), bias.detach(), eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = (xf - mean) * rstd
        gy = gf * weight.float()
        dx = rstd * (gy - gy.mean(dim=-1, keepdim=True)
                     - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
        lead = tuple(range(x.dim() - 1))
        dweight = (gf * xhat).sum(dim=lead).to(weight.dtype)
        dbias = gf.sum(dim=lead).to(weight.dtype)
        return dx.to(x.dtype), dweight, dbias, None


def layernorm_autograd(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Differentiable `layernorm` (x contiguous)."""
    return _LayerNorm.apply(x, weight, bias, eps)
