"""B12: the int8 product of a w8a8 linear (kernel `csrc/quant_matmul.cu`) and
its plain version, plus the int8 helpers the quantized path shares.

Replaces `on_device_image_captioning_tpu/ops/quant_matmul.py::
quantized_matmul_pallas`. The numbers are those of `deploy/quantization.py::
quantized_matmul` there, the function the JAX model computes (the Pallas
kernel itself divides by a bf16 scale in fp32 and so differs from it at bf16;
ROADMAP §C):

    s_x = max(max|x|, 1e-8) / 127 in x's dtype    (dynamic; or a calibrated fp32 scale)
    q   = clip(rint(x / s_x), -127, 127)          (the quotient in the promoted dtype)
    y   = float(q @ Wq^T) * (s_x * s_w) + b       (int32 accumulation, fp32 out)

Weights are stored as torch stores a linear's, (out, in), here int8 with one
fp32 scale per output channel. The dynamic scale is a PyTorch reduction on the
device (it lies outside the Pallas kernel in JAX too) and reaches the kernel
as a device scalar: no launch waits for the host. The plain versions sum the
int8 products exactly, in float64 (every partial sum is an integer below
2^53; an fp32 sum of them is not exact above K ~ 1040), on any device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0  # kernel launches since the last reset (plain-version calls do not count)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
QMAX = 127.0


def int_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """a_q (M, K) @ b_q (K, N) of int8 values, exact, as int32."""
    return torch.matmul(a_q.double(), b_q.double()).to(torch.int32)


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale max(max|x|, 1e-8) / 127, a 0-d tensor in x's dtype."""
    return torch.clamp(x.abs().amax(), min=1e-8) / QMAX


def row_scales(h: torch.Tensor) -> torch.Tensor:
    """Per-row scales (R, 1) of fp32 rows h (R, C): max(max|h_r|, 1e-8) / 127."""
    return torch.clamp(h.abs().amax(dim=-1, keepdim=True), min=1e-8) / QMAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(rint(x / scale), -127, 127) as int8, the quotient in the dtype the
    two promote to, as JAX promotes arrays (a 0-d fp32 scale makes a bf16 x's
    quotient fp32, which torch's own rule for 0-d tensors would not)."""
    ct = torch.promote_types(x.dtype, scale.dtype)
    return torch.round(x.to(ct) / scale.to(ct)).clamp(-QMAX, QMAX).to(torch.int8)


def quantized_matmul_reference(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, x_scale: Optional[torch.Tensor] = None,
    xq_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (..., K) fp32 or bf16; w_q (N, K) int8; w_scale (N,) fp32; bias (N,)
    fp32 or None; x_scale a 0-d calibrated scale or None for the dynamic one.
    Returns (..., N) fp32. xq_out, an int8 tensor of x's shape, receives the
    quantized x."""
    xs = dynamic_scale(x) if x_scale is None else x_scale
    xq = quantize(x, xs)
    if xq_out is not None:
        xq_out.copy_(xq)
    k = x.shape[-1]
    acc = int_matmul(xq.reshape(-1, k), w_q.t())
    y = acc.float() * (xs.float() * w_scale)
    if bias is not None:
        y = y + bias
    return y.reshape(*x.shape[:-1], w_q.shape[0])


def _check(x, w_q, w_scale, bias, x_scale, xq_out) -> None:
    k = x.shape[-1]
    n = w_q.shape[0] if w_q.dim() == 2 else -1
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"quantized_matmul: x must be fp32 or bf16, got {x.dtype}")
    if w_q.dtype != torch.int8 or w_q.shape != (n, k) or k % 16:
        raise ValueError("quantized_matmul: w_q must be int8 (N, K), K a multiple of 16")
    if w_scale.dtype != torch.float32 or w_scale.shape != (n,):
        raise ValueError("quantized_matmul: w_scale must be fp32 (N,)")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise ValueError("quantized_matmul: bias must be fp32 (N,)")
    if x_scale is not None and (x_scale.numel() != 1 or x_scale.dtype not in _DTYPE_CODE):
        raise ValueError("quantized_matmul: x_scale must be one fp32 or bf16 value")
    if xq_out is not None and (xq_out.dtype != torch.int8 or xq_out.shape != x.shape):
        raise ValueError("quantized_matmul: xq_out must be int8 of x's shape")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the kernels move 16-byte chunks)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def quantized_matmul(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, x_scale: Optional[torch.Tensor] = None,
    xq_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The int8 product (see the module docstring). CPU tensors get the plain
    version; CUDA tensors get kernel B12, which takes K a multiple of 16 and
    raises on anything else it does not take."""
    global launches
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w_q, w_scale, bias, x_scale, xq_out)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    _check(x, w_q, w_scale, bias, x_scale, xq_out)
    k, n = x.shape[-1], w_q.shape[0]
    x2 = aligned(x.reshape(-1, k))
    m = x2.shape[0]
    xs = dynamic_scale(x2) if x_scale is None else x_scale
    round_bf16 = torch.promote_types(x.dtype, xs.dtype) == torch.bfloat16
    xs32 = xs.reshape(1).float()
    _build.check_cuda_tensors(*[t for t in (x2, xs32, w_q, w_scale, bias, xq_out)
                                if t is not None])
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.cuda_function(
        "quant_matmul", "quant_matmul_launch",
        [_P, _P, ctypes.c_int] + [_P] * 5 + [ctypes.c_int] * 4 + [_P])
    status = fn(
        x2.data_ptr(), xs32.data_ptr(), int(round_bf16), w_q.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if xq_out is None else xq_out.data_ptr(), m, n, k, _DTYPE_CODE[x.dtype],
        _build.current_stream())
    _build.check_status(status, "quant_matmul")
    launches += 1
    return out.reshape(*x.shape[:-1], n)
