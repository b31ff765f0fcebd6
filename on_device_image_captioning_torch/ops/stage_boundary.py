"""The stage boundaries of the window-resident Swin backbone: patch embed and
patch merging (downsample), writing and reading the window layout the
half-block kernels run in. Each kernel sits beside its plain version.

Replaces, from `on_device_image_captioning_tpu/ops/stage_boundary.py`:

- `patch_embed_fused` (B7): space-to-depth rows -> product + bias ->
  LayerNorm -> window layout;
- `downsample_fused` (B8): window layout in -> 2x2 merge -> LayerNorm(4C) ->
  product 4C -> 2C without bias -> window layout out.

Both are one launch of `csrc/stage_boundary.cu`; the window partition and the
2x2 merge are index arithmetic where the kernel reads its rows (no
`merge_selection` matrix). Operands as in `ops/swin_block_fused.py`: (in, out)
weights in x's dtype, fp32 LayerNorm parameters and bias. Bounds and designs:
the header of the `.cu`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layernorm import layernorm_reference
from .linear_plan import form_for
from .swin_block_fused import (
    _DTYPE_CODE, _P, Linear, Norm, _check_device, _check_linears, _check_norm, _flat, _ptr,
    _ln_scratch, linear_reference,
)
from .window_layout import window_partition, window_reverse

patch_embed_launches = 0  # kernel launches since the last reset
downsample_launches = 0
MAX_EMBED_DIM = 192  # B7 holds whole output rows in one block (Swin-L's width)


def patch_embed_reference(
    x_s2d: torch.Tensor, proj: Linear, norm: Norm, window: int, eps: float
) -> torch.Tensor:
    b, res, _, k = x_s2d.shape
    y = linear_reference(x_s2d.reshape(-1, k), *proj)
    y = layernorm_reference(y, norm[0], norm[1], eps)
    return window_partition(y.reshape(b, res, res, -1), window)


def downsample_reference(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float
) -> torch.Tensor:
    res = w_in * window
    x = window_reverse(xw, window, res, res)
    x = torch.cat(
        [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
    )
    y = linear_reference(layernorm_reference(x, norm[0], norm[1], eps), reduction, None)
    return window_partition(y, window)


def patch_embed_fused(
    x_s2d: torch.Tensor, proj: Linear, norm: Norm, window: int, eps: float
) -> torch.Tensor:
    """x_s2d (B, res, res, ps*ps*3): space-to-depth'd images in the compute
    dtype -> the patch embedding in window layout (B*(res/window)^2,
    window^2, embed_dim). CPU tensors get the plain version; CUDA tensors get
    kernel B7."""
    global patch_embed_launches
    if not _check_device(x_s2d, "patch_embed_fused"):
        return patch_embed_reference(x_s2d, proj, norm, window, eps)
    b, res, res2, k = x_s2d.shape
    c = proj[0].shape[1]
    if res != res2 or res % window:
        raise ValueError("patch_embed_fused: the patch grid must be square and tile the window")
    if proj[0].shape[0] != k or c > MAX_EMBED_DIM:
        raise ValueError(f"patch_embed_fused: proj must be ({k}, C) with C <= {MAX_EMBED_DIM}")
    if proj[0].dtype != x_s2d.dtype or k % 16 or proj[1] is None or proj[1].dtype != torch.float32:
        raise ValueError("patch_embed_fused: proj must be (w in x's dtype, fp32 bias), K % 16 == 0")
    _check_norm("patch_embed_fused", norm, c)
    _build.check_cuda_tensors(*_flat([x_s2d, *proj, *norm]))
    out = torch.empty((b * (res // window) ** 2, window * window, c),
                      dtype=x_s2d.dtype, device=x_s2d.device)
    fn = _build.cuda_function(
        "stage_boundary", "patch_embed_launch",
        [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, _P],
    )
    status = fn(
        x_s2d.data_ptr(), proj[0].data_ptr(), _ptr(proj[1]), norm[0].data_ptr(),
        norm[1].data_ptr(), out.data_ptr(), b, res, window, k, c, float(eps),
        _DTYPE_CODE[x_s2d.dtype], _build.current_stream(),
    )
    _build.check_status(status, "patch_embed_fused")
    patch_embed_launches += 1
    return out


def downsample_fused(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float
) -> torch.Tensor:
    """xw (B*w_in^2, n, C): window layout of a stage -> the next stage's input
    (B*(w_in/2)^2, n, 2C), also in window layout. reduction is the (4C, 2C)
    weight (no bias). CPU tensors get the plain version; CUDA tensors get
    kernel B8."""
    global downsample_launches
    if not _check_device(xw, "downsample_fused"):
        return downsample_reference(xw, norm, reduction, w_in, window, eps)
    bw, n, c = xw.shape
    if n != window * window or w_in % 2 or bw % (w_in * w_in):
        raise ValueError("downsample_fused: xw must be (B*w_in^2, window^2, C), w_in even")
    if reduction.shape != (4 * c, 2 * c) or c % 32:
        raise ValueError("downsample_fused: reduction must be (4C, 2C), C a multiple of 32")
    _check_linears("downsample_fused", xw.dtype, (reduction, None))
    _check_norm("downsample_fused", norm, 4 * c)
    _build.check_cuda_tensors(xw, *norm, reduction)
    b = bw // (w_in * w_in)
    out = torch.empty((bw // 4, n, 2 * c), dtype=xw.dtype, device=xw.device)
    fn = _build.cuda_function(
        "stage_boundary", "downsample_launch",
        [_P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, _P, ctypes.c_int, _P],
    )
    status = fn(
        xw.data_ptr(), norm[0].data_ptr(), norm[1].data_ptr(), reduction.data_ptr(),
        out.data_ptr(), b, w_in * window, window, c, float(eps),
        form_for(xw, bw * n // 4, 2 * c, 4 * c, 4), _ptr(_ln_scratch(xw, bw * n // 4, 4 * c)),
        _DTYPE_CODE[xw.dtype], _build.current_stream(),
    )
    _build.check_status(status, "downsample_fused")
    downsample_launches += 1
    return out
