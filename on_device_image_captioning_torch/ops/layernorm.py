"""Row LayerNorm over the last axis: a Triton kernel and its plain version.

Replaces `on_device_image_captioning_tpu/ops/layernorm.py::layernorm_pallas`:
the kernel is the forward; as there, the gradient (`layernorm_autograd`) is
the plain formula from the saved (x, scale), on either device.

What bounds it on the H100: bytes. Each row is read once and written once
(2 x rows x C x itemsize) with a handful of flops per element, far below the
card's ~295 flop/byte balance point. The design keeps the row in registers:
one program per row, a masked power-of-two block (`next_power_of_2(C)`)
covering the non-power-of-two widths 192/384/768/1536/3072/512, statistics in
fp32 (biased variance, eps 1e-5), output in the input dtype. No tensor-core
work, so Triton serves as well as CUDA would.
"""
from __future__ import annotations

import functools

import torch

from . import _build

launches = 0  # kernel launches since the last reset (plain-version calls do not count)


def layernorm_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """torch.nn.LayerNorm semantics with fp32 statistics; output in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    _build.triton_cache_dir()
    import triton
    import triton.language as tl

    @triton.jit
    def layernorm_kernel(
        x_ptr, w_ptr, b_ptr, out_ptr, C, eps, BLOCK: tl.constexpr
    ):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        m = cols < C
        x = tl.load(x_ptr + row * C + cols, mask=m, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / C
        diff = tl.where(m, x - mean, 0.0)
        var = tl.sum(diff * diff, axis=0) / C
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=m, other=0.0)
        b = tl.load(b_ptr + cols, mask=m, other=0.0)
        y = diff * rstd * w + b
        tl.store(out_ptr + row * C + cols, y.to(out_ptr.dtype.element_ty), mask=m)

    return triton, layernorm_kernel


def layernorm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape). CPU tensors get
    the plain version; CUDA tensors get the Triton kernel."""
    global launches
    if x.device.type == "cpu":
        return layernorm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layernorm: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("layernorm: weight/bias must have shape (C,)")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("layernorm: weight and bias must be float32")
    _build.check_cuda_tensors(x, weight, bias)
    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    triton, kernel = _kernel()
    block = triton.next_power_of_2(c)
    kernel[(rows,)](
        x, weight, bias, out, c, eps, BLOCK=block,
        num_warps=4 if block <= 1024 else 8,
    )
    launches += 1
    return out


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
