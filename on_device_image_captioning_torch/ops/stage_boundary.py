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


def _patch_embed_cuda(x_s2d, proj_w, proj_b, norm_w, norm_b, window: int, eps: float,
                      ctas: Optional[int]) -> torch.Tensor:
    """Kernel B7 on CUDA tensors: the CUDA kernel of `odic::patch_embed`, on
    `ctas` persistent CTAs of the bf16 kernel (0: the CUDA cores' kernel;
    None: `embed_plan`'s grid)."""
    global patch_embed_launches
    b, res, res2, k = x_s2d.shape
    c = proj_w.shape[1]
    if x_s2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"patch_embed_fused: unsupported dtype {x_s2d.dtype}")
    if res != res2 or res % window:
        raise ValueError("patch_embed_fused: the patch grid must be square and tile the window")
    if proj_w.shape[0] != k or c > MAX_EMBED_DIM:
        raise ValueError(f"patch_embed_fused: proj must be ({k}, C) with C <= {MAX_EMBED_DIM}")
    if proj_w.dtype != x_s2d.dtype or k % 16 or proj_b.dtype != torch.float32:
        raise ValueError("patch_embed_fused: proj must be (w in x's dtype, fp32 bias), K % 16 == 0")
    _check_norm("patch_embed_fused", (norm_w, norm_b), c)
    _build.check_cuda_tensors(x_s2d, proj_w, proj_b, norm_w, norm_b)
    if ctas is None:
        ctas = embed_plan(b * res * res, k, c, x_s2d.element_size(), sm_count(x_s2d.device)).ctas
    out = torch.empty((b * (res // window) ** 2, window * window, c),
                      dtype=x_s2d.dtype, device=x_s2d.device)
    fn = _build.cuda_function(
        "stage_boundary", "patch_embed_launch",
        [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    )
    status = fn(
        x_s2d.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(), norm_w.data_ptr(),
        norm_b.data_ptr(), out.data_ptr(), b, res, window, k, c, float(eps), ctas,
        _DTYPE_CODE[x_s2d.dtype], _build.current_stream(),
    )
    _build.check_status(status, "patch_embed_fused")
    patch_embed_launches += 1
    return out


def _patch_embed_fake(x_s2d, proj_w, proj_b, norm_w, norm_b, window, eps, ctas):
    b, res = x_s2d.shape[:2]
    return x_s2d.new_empty((b * (res // window) ** 2, window * window, proj_w.shape[1]))


_patch_embed_op = _build.define_op(
    "patch_embed",
    "(Tensor x_s2d, Tensor proj_w, Tensor proj_b, Tensor norm_w, Tensor norm_b, int window, "
    "float eps, int? ctas) -> Tensor",
    lambda x, pw, pb, nw, nb, window, eps, ctas: patch_embed_reference(
        x, (pw, pb), (nw, nb), window, eps),
    _patch_embed_cuda, _patch_embed_fake)


def patch_embed_fused(
    x_s2d: torch.Tensor, proj: Linear, norm: Norm, window: int, eps: float
) -> torch.Tensor:
    """x_s2d (B, res, res, ps*ps*3): space-to-depth'd images in the compute
    dtype -> the patch embedding in window layout (B*(res/window)^2,
    window^2, embed_dim): `odic::patch_embed`, the plain version on CPU
    tensors, kernel B7 on CUDA tensors."""
    return _patch_embed_op(x_s2d, *proj, *norm, window, eps, None)


def patch_embed_launch(
    x_s2d: torch.Tensor, proj: Linear, norm: Norm, window: int, eps: float,
    plan: Optional[EmbedPlan] = None,
) -> torch.Tensor:
    """`odic::patch_embed` in `plan` (None: `embed_plan`'s; or any other
    grid of the bf16 kernel)."""
    if plan is not None:
        b, res = x_s2d.shape[:2]
        rows, k, c = b * res * res, x_s2d.shape[-1], proj[0].shape[1]
        if plan.rows != rows or (plan.ctas > 0) != (
                embed_plan(rows, k, c, x_s2d.element_size(), 1).ctas > 0):
            raise ValueError("patch_embed_launch: the plan is for other rows or another route")
    if proj[1] is None:
        raise ValueError("patch_embed_fused: proj must have its fp32 bias")
    return _patch_embed_op(x_s2d, *proj, *norm, window, eps, None if plan is None else plan.ctas)


def _check_downsample(xw, norm, reduction, w_in, window):
    bw, n, c = xw.shape
    if xw.dtype not in _DTYPE_CODE:
        raise ValueError(f"downsample_fused: unsupported dtype {xw.dtype}")
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


def _downsample_cuda(xw, norm_w, norm_b, reduction, w_in: int, window: int, eps: float,
                     form: Optional[int], splits: Optional[int],
                     scratch: Optional[torch.Tensor], prologue_ready: bool) -> torch.Tensor:
    """Kernel B8 on CUDA tensors: the CUDA kernel of `odic::downsample`, in
    the form and split given (None: `downsample_plan`'s). scratch: the first
    launch's output for the product (allocated here when None);
    prologue_ready launches the product alone on what an earlier launch left
    there."""
    global downsample_launches
    norm = (norm_w, norm_b)
    _check_downsample(xw, norm, reduction, w_in, window)
    bw, n, c = xw.shape
    plan = downsample_plan(xw, form, splits)
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
        xw.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(), reduction.data_ptr(),
        out.data_ptr(), bw // (w_in * w_in), w_in * window, window, c, float(eps),
        plan.form, plan.splits, plan.k_chunk, _ptr(scratch), int(prologue_ready),
        _DTYPE_CODE[xw.dtype], _build.current_stream(),
    )
    _build.check_status(status, "downsample_fused")
    downsample_launches += 1
    return out


def _downsample_fake(xw, norm_w, norm_b, reduction, w_in, window, eps, form, splits, scratch,
                     prologue_ready):
    bw, n, c = xw.shape
    return xw.new_empty((bw // 4, n, 2 * c))


_downsample_op = _build.define_op(
    "downsample",
    "(Tensor xw, Tensor norm_w, Tensor norm_b, Tensor reduction, int w_in, int window, "
    "float eps, int? form, int? splits, Tensor(a!)? scratch, bool prologue_ready) -> Tensor",
    lambda xw, nw, nb, red, w_in, window, eps, form, splits, scratch, ready: (
        downsample_reference(xw, (nw, nb), red, w_in, window, eps)),
    _downsample_cuda, _downsample_fake)


def downsample_launch(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float,
    plan: Optional[MergePlan] = None, scratch: Optional[torch.Tensor] = None,
    prologue_ready: bool = False,
) -> torch.Tensor:
    """`odic::downsample` in `plan` (None: `downsample_plan`'s; or any other
    form and split `merge_plan` takes). scratch: the first launch's output
    for the product (`downsample_scratch`'s shape; allocated by the kernel
    when None); prologue_ready=True launches the product alone on what an
    earlier launch left there."""
    form = splits = None
    if plan is not None:
        bw, n, c = xw.shape
        if (plan.m, plan.n, plan.k) != (bw * n // 4, 2 * c, 4 * c) or (plan.form < 0) != (
                xw.dtype == torch.float32):
            raise ValueError("downsample_launch: the plan is for other shapes or another dtype")
        form, splits = (None, None) if plan.form < 0 else (plan.form, plan.splits)
    return _downsample_op(xw, *norm, reduction, w_in, window, eps, form, splits, scratch,
                          prologue_ready)


def downsample_fused(
    xw: torch.Tensor, norm: Norm, reduction: torch.Tensor, w_in: int, window: int, eps: float
) -> torch.Tensor:
    """xw (B*w_in^2, n, C): window layout of a stage -> the next stage's input
    (B*(w_in/2)^2, n, 2C), also in window layout. reduction is the (4C, 2C)
    weight (no bias). `odic::downsample`: the plain version on CPU tensors,
    kernel B8 on CUDA tensors."""
    return _downsample_op(xw, *norm, reduction, w_in, window, eps, None, None, None, False)
