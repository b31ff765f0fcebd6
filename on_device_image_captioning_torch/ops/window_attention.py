"""Swin window-attention core (kernel K1, `csrc/window_attention.cu`) and its
plain version.

Replaces `on_device_image_captioning_tpu/ops/window_attention.py::
window_attention_pallas` and, on the same math, `ops/swin_block_fused.py::
attention_core_fused`: one kernel on the flat qkv layout serves both. The qkv
and proj GEMMs stay `torch.matmul`, as they stay plain GEMMs in JAX.

Bound and design: see the header of `csrc/window_attention.cuh` (one CTA per
(window, head), K/V whole in shared memory; bf16 windows of 144 tokens on the
tensor cores, everything else fp32 CUDA-core math).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0  # kernel launches since the last reset (plain-version calls do not count)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 32  # Swin-L's dk at every stage; the only width K1 is built for
_SMEM_LIMIT = 48 * 1024  # default dynamic shared memory per block


def window_attention_reference(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    heads: int,
    scale: float,
) -> torch.Tensor:
    """qkv (BW, N, 3C) -> (BW, N, C). bias (H, N, N) fp32; mask (nW, N, N)
    fp32 additive or None, picked by window index w % nW."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    dk = c // heads
    q, k, v = qkv.reshape(bw, n, 3, heads, dk).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n) + mask.float()[None, :, None])
        s = s.reshape(bw, heads, n, n)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # (BW, H, N, dk)
    return out.transpose(1, 2).reshape(bw, n, c)


def _library():
    lib = _build.load_cuda_library("window_attention")
    fn = lib.window_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def window_attention(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    heads: int,
    scale: float,
) -> torch.Tensor:
    """Window attention over the flat qkv layout. CPU tensors get the plain
    version; CUDA tensors get kernel K1."""
    global launches
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {qkv.device}")
    bw, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c != heads * HEAD_DIM:
        raise ValueError(f"window_attention: K1 takes head width {HEAD_DIM}, got "
                         f"qkv width {c3} / heads {heads}")
    if qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"window_attention: unsupported dtype {qkv.dtype}")
    if bias.dtype != torch.float32 or bias.shape != (heads, n, n):
        raise ValueError("window_attention: bias must be fp32 (H, N, N)")
    operands = [qkv, bias]
    num_windows = 1
    if mask is not None:
        num_windows = mask.shape[0]
        if mask.dtype != torch.float32 or mask.shape[1:] != (n, n) or bw % num_windows:
            raise ValueError("window_attention: mask must be fp32 (nW, N, N), nW | BW")
        operands.append(mask)
    if 2 * n * HEAD_DIM * 4 > _SMEM_LIMIT:
        raise ValueError(f"window_attention: window of {n} tokens exceeds shared memory")
    _build.check_cuda_tensors(*operands)
    out = torch.empty((bw, n, c), dtype=qkv.dtype, device=qkv.device)
    fn = _library()
    status = fn(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        bw, n, c, heads, num_windows, float(scale), _DTYPE_CODE[qkv.dtype],
        _build.current_stream(),
    )
    _build.check_status(status, "window_attention")
    launches += 1
    return out
