"""The stage boundaries of the window-resident Swin backbone: patch embed and
patch merging (downsample), writing and reading the window layout the
half-block kernels run in. Each kernel sits beside its plain version.

Replaces, from `on_device_image_captioning_tpu/ops/stage_boundary.py`:

- `patch_embed_fused` (B7): space-to-depth rows -> product + bias ->
  LayerNorm -> window layout;
- `downsample_fused` (B8): window layout in -> 2x2 merge -> LayerNorm(4C) ->
  product 4C -> 2C without bias -> window layout out.

Both run `csrc/stage_boundary.cu`; the window partition and the 2x2 merge are
index arithmetic where the kernel reads its rows (no `merge_selection`
matrix). B7 in bf16 is one persistent launch in the grid `embed_plan` picks;
B8 in bf16 is two launches in the route, tile and K split
`linear_plan.merge_plan` picks: where K is split, a row-statistics pre-pass
and the product with the LayerNorm applied in its ring; else the normalized
rows into scratch and the product on them. fp32 runs both on the CUDA cores
in one launch. Operands as in `ops/swin_block_fused.py`: (in, out) weights in x's
dtype, fp32 LayerNorm parameters and bias. Bounds and designs: the header of
the `.cu`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .layernorm import layernorm_reference
from .linear_plan import MergePlan, merge_plan, sm_count
from .swin_block_fused import (
    _DTYPE_CODE, _P, Linear, Norm, _check_device, _check_linears, _check_norm, _flat, _ptr,
    linear_reference,
)
from .window_layout import window_partition, window_reverse

patch_embed_launches = 0  # kernel launches since the last reset
downsample_launches = 0
MAX_EMBED_DIM = 192  # the CUDA cores' B7 holds whole output rows in one block (Swin-L's width)
# `patch_embed_wgmma_kernel` of csrc/stage_boundary.cu (the CPU tests read
# them there): output width, rows a tile, CTAs an SM, the widest input row
EMBED_N, EMBED_ROWS, EMBED_CTAS, EMBED_MAX_K = 192, 64, 3, 48


@dataclasses.dataclass(frozen=True)
class EmbedPlan:
    rows: int
    tiles: int  # row tiles of EMBED_ROWS (0 on the CUDA cores' route)
    ctas: int  # persistent CTAs of the bf16 kernel; 0 = the CUDA cores' kernel

    def tiles_of(self, cta: int) -> range:
        """The row tiles CTA `cta` walks, in order."""
        return range(cta, self.tiles, self.ctas)


@functools.lru_cache(maxsize=256)
def embed_plan(rows: int, k: int, c: int, itemsize: int, sms: int) -> EmbedPlan:
    """B7's launch: bf16 at C = EMBED_N with K a multiple of 16 up to
    EMBED_MAX_K on the tensor cores, on as few persistent CTAs as give every
    one the same number of tiles within the card's slots (EMBED_CTAS an SM);
    anything else on the CUDA cores."""
    if itemsize != 2 or c != EMBED_N or k % 16 or not 16 <= k <= EMBED_MAX_K:
        return EmbedPlan(rows, 0, 0)
    tiles = -(-rows // EMBED_ROWS)
    rounds = -(-tiles // (sms * EMBED_CTAS))
    return EmbedPlan(rows, tiles, -(-tiles // rounds))


def patch_embed_reference(
    x_s2d: torch.Tensor, proj: Linear, norm: Norm, window: int, eps: float
) -> torch.Tensor:
    b, res, _, k = x_s2d.shape
    y = linear_reference(x_s2d.reshape(-1, k), *proj)
    y = layernorm_reference(y, norm[0], norm[1], eps)
    return window_partition(y.reshape(b, res, res, -1), window)


def _merged_rows(xw: torch.Tensor, w_in: int, window: int) -> torch.Tensor:
    """The 2x2 merge: (B, res/2, res/2, 4C) in the concat order (even,even),
    (odd,even), (even,odd), (odd,odd)."""
    res = w_in * window
    x = window_reverse(xw, window, res, res)
    return torch.cat(
        [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
    )


def downsample_reference(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float
) -> torch.Tensor:
    x = _merged_rows(xw, w_in, window)
    y = linear_reference(layernorm_reference(x, norm[0], norm[1], eps), reduction, None)
    return window_partition(y, window)


def downsample_split_reference(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float,
    plan: MergePlan,
) -> torch.Tensor:
    """B8's bf16 kernel as plain tensor code: the normalized rows rounded to
    x's dtype, each split's K chunk of the product summed in fp32, the
    partials added in split order (the cluster's rank order), the result
    rounded once."""
    x = layernorm_reference(_merged_rows(xw, w_in, window), norm[0], norm[1], eps).float()
    w = reduction.float()
    y = None
    for chunk in plan.k_chunks():
        part = torch.matmul(x[..., chunk.start:chunk.stop], w[chunk.start:chunk.stop])
        y = part if y is None else y + part
    return window_partition(y.to(xw.dtype), window)


def patch_embed_fused(
    x_s2d: torch.Tensor, proj: Linear, norm: Norm, window: int, eps: float
) -> torch.Tensor:
    """x_s2d (B, res, res, ps*ps*3): space-to-depth'd images in the compute
    dtype -> the patch embedding in window layout (B*(res/window)^2,
    window^2, embed_dim). CPU tensors get the plain version; CUDA tensors get
    kernel B7."""
    if not _check_device(x_s2d, "patch_embed_fused"):
        return patch_embed_reference(x_s2d, proj, norm, window, eps)
    return patch_embed_launch(x_s2d, proj, norm, window, eps)


def patch_embed_launch(
    x_s2d: torch.Tensor, proj: Linear, norm: Norm, window: int, eps: float,
    plan: Optional[EmbedPlan] = None,
) -> torch.Tensor:
    """Kernel B7 on CUDA tensors in `plan` (None: `embed_plan`'s; or any
    other grid of the bf16 kernel)."""
    global patch_embed_launches
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
    rows = b * res * res
    plan = plan or embed_plan(rows, k, c, x_s2d.element_size(), sm_count(x_s2d.device))
    if plan.rows != rows or (plan.ctas > 0) != (embed_plan(rows, k, c, x_s2d.element_size(),
                                                           1).ctas > 0):
        raise ValueError("patch_embed_launch: the plan is for other rows or another route")
    out = torch.empty((b * (res // window) ** 2, window * window, c),
                      dtype=x_s2d.dtype, device=x_s2d.device)
    fn = _build.cuda_function(
        "stage_boundary", "patch_embed_launch",
        [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    )
    status = fn(
        x_s2d.data_ptr(), proj[0].data_ptr(), _ptr(proj[1]), norm[0].data_ptr(),
        norm[1].data_ptr(), out.data_ptr(), b, res, window, k, c, float(eps), plan.ctas,
        _DTYPE_CODE[x_s2d.dtype], _build.current_stream(),
    )
    _build.check_status(status, "patch_embed_fused")
    patch_embed_launches += 1
    return out


def _check_downsample(xw, norm, reduction, w_in, window):
    bw, n, c = xw.shape
    if n != window * window or w_in % 2 or bw % (w_in * w_in):
        raise ValueError("downsample_fused: xw must be (B*w_in^2, window^2, C), w_in even")
    if reduction.shape != (4 * c, 2 * c) or c % 32:
        raise ValueError("downsample_fused: reduction must be (4C, 2C), C a multiple of 32")
    _check_linears("downsample_fused", xw.dtype, (reduction, None))
    _check_norm("downsample_fused", norm, 4 * c)
    _build.check_cuda_tensors(xw, *norm, reduction)


def downsample_plan(xw: torch.Tensor, form: Optional[int] = None,
                    splits: Optional[int] = None) -> MergePlan:
    """The product's plan for xw (B*w_in^2, n, C) on its card and dtype."""
    bw, n, c = xw.shape
    return merge_plan(bw * n // 4, 2 * c, 4 * c, 4, xw.element_size(), sm_count(xw.device),
                      form, splits)


def downsample_scratch(xw: torch.Tensor, plan: MergePlan) -> Optional[torch.Tensor]:
    """What B8's first launch leaves for its product in `plan`: the row
    statistics (rows, 2) fp32 where K is split, the normalized rows (rows,
    4C) in x's dtype on the scratch route; None in fp32."""
    if xw.dtype == torch.float32:
        return None
    shape = (plan.m, 2) if plan.ring else (plan.m, plan.k)
    return torch.empty(shape, dtype=torch.float32 if plan.ring else xw.dtype, device=xw.device)


def downsample_launch(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float,
    plan: Optional[MergePlan] = None, scratch: Optional[torch.Tensor] = None,
    prologue_ready: bool = False,
) -> torch.Tensor:
    """Kernel B8 on CUDA tensors in `plan` (None: `downsample_plan`'s; or
    any other form and split `merge_plan` takes). scratch: the first launch's
    output for the product (`downsample_scratch`'s shape; allocated here when
    None); prologue_ready=True launches the product alone on what an earlier
    launch left there."""
    global downsample_launches
    _check_downsample(xw, norm, reduction, w_in, window)
    bw, n, c = xw.shape
    plan = plan or downsample_plan(xw)
    if (plan.m, plan.n, plan.k) != (bw * n // 4, 2 * c, 4 * c) or (plan.form < 0) != (
            xw.dtype == torch.float32):
        raise ValueError("downsample_launch: the plan is for other shapes or another dtype")
    if xw.dtype == torch.bfloat16:
        want = downsample_scratch(xw, plan)
        if scratch is None:
            if prologue_ready:
                raise ValueError("downsample_launch: prologue_ready needs the scratch")
            scratch = want
        elif scratch.shape != want.shape or scratch.dtype != want.dtype:
            raise ValueError(f"downsample_launch: scratch must be {want.dtype} "
                             f"{tuple(want.shape)}")
        _build.check_cuda_tensors(xw, scratch)
    out = torch.empty((bw // 4, n, 2 * c), dtype=xw.dtype, device=xw.device)
    fn = _build.cuda_function(
        "stage_boundary", "downsample_launch",
        [_P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
        + [_P, ctypes.c_int, ctypes.c_int, _P],
    )
    status = fn(
        xw.data_ptr(), norm[0].data_ptr(), norm[1].data_ptr(), reduction.data_ptr(),
        out.data_ptr(), bw // (w_in * w_in), w_in * window, window, c, float(eps),
        plan.form, plan.splits, plan.k_chunk, _ptr(scratch), int(prologue_ready),
        _DTYPE_CODE[xw.dtype], _build.current_stream(),
    )
    _build.check_status(status, "downsample_fused")
    downsample_launches += 1
    return out


def downsample_fused(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float
) -> torch.Tensor:
    """xw (B*w_in^2, n, C): window layout of a stage -> the next stage's input
    (B*(w_in/2)^2, n, 2C), also in window layout. reduction is the (4C, 2C)
    weight (no bias). CPU tensors get the plain version; CUDA tensors get
    kernel B8."""
    if not _check_device(xw, "downsample_fused"):
        return downsample_reference(xw, norm, reduction, w_in, window, eps)
    return downsample_launch(xw, norm, reduction, w_in, window, eps)
