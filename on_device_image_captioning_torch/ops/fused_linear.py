"""The backbone's shared product alone (`csrc/fused_linear.cuh` through
`csrc/linear.cu`), beside its plain version:

    out = epilogue(prologue(gather(a)) @ w)

with the gathers of `window_layout.cuh::map_row` (identity, the window
transition, the 2x2 merge as four segments along K), the optional row
LayerNorm prologue, and the epilogue's bias, exact-erf GELU, gathered
residual and per-image scale, each rounded where B4, B5 and B8 round. The main
path reaches the product only through those kernels' wrappers; this entry is
for the card tests of the product's shapes and maps and for timing it beside
a library product (`chip_smoke.py` phase 6).

`grad_product` is the training backwards' product alone (B9b, B9c reach it
through their own wrappers), in its three operand layouts, for the same two
uses.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .layernorm import layernorm_reference
from .linear_plan import GRAD_LAYOUTS, form_for, grad_plan, sm_count
from .swin_block_fused import _DTYPE_CODE, _P, Norm, _ptr, _ln_scratch, linear_reference
from .window_layout import source_rows

launches = 0  # kernel launches since the last reset (plain-version calls do not count)
grad_launches = 0  # grad_product calls that launched the backward product
# (kind, res, window, delta): kind "transition" (a_map 1) or "merge" (a_map 3,
# four segments along K, delta unused) over a res x res grid
Gather = Tuple[str, int, int, int]
_MAPS = {None: 0, "transition": 1, "merge": 3}


def _gather_index(gather: Optional[Gather], m: int, segs: int):
    """Per output row and segment, the source row the kernel reads."""
    if gather is None:
        return [torch.arange(m)]
    kind, res, window, delta = gather
    per_out = (res // 2) ** 2 if kind == "merge" else res * res
    images = torch.arange(m // per_out)[:, None] * res * res
    return [(images + torch.from_numpy(source_rows(kind, res, window, delta, seg))).reshape(-1)
            for seg in range(segs)]


def fused_linear_reference(
    a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
    norm: Optional[Norm] = None, *, m: Optional[int] = None, gather: Optional[Gather] = None,
    gelu: bool = False, resid: Optional[torch.Tensor] = None,
    resid_gather: Optional[Gather] = None, row_scale: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    segs = 4 if gather is not None and gather[0] == "merge" else 1
    m = a.shape[0] if m is None else m
    idx = _gather_index(gather, m, segs)
    x = torch.cat([a[i.to(a.device)] for i in idx], dim=-1)
    if norm is not None:
        x = layernorm_reference(x, norm[0], norm[1], eps)
    y = linear_reference(x, w, bias)
    if gelu:
        y = F.gelu(y.float()).to(y.dtype)  # exact erf, in fp32
    if resid is not None:
        r = resid[_gather_index(resid_gather, m, 1)[0].to(resid.device)]
        s = 1.0 if row_scale is None else row_scale.repeat_interleave(m // row_scale.numel())[:, None]
        y = (r.float() + s * y.float()).to(y.dtype)
    return y


def _gather_ints(gather: Optional[Gather]) -> Optional[List[int]]:
    """A gather as the op takes it: [map code, res, window, delta]."""
    return None if gather is None else [_MAPS[gather[0]], *gather[1:]]


def _gather_of(ints) -> Optional[Gather]:
    if ints is None:
        return None
    code, res, window, delta = ints
    return (next(k for k, v in _MAPS.items() if v == code), res, window, delta)


def _fused_linear_plain(a, w, bias, norm_w, norm_b, m, gather, gelu, resid, resid_gather,
                        row_scale, eps, form):
    return fused_linear_reference(
        a, w, bias, None if norm_w is None else (norm_w, norm_b), m=m, gather=_gather_of(gather),
        gelu=gelu, resid=resid, resid_gather=_gather_of(resid_gather), row_scale=row_scale,
        eps=eps)


def _fused_linear_cuda(a, w, bias, norm_w, norm_b, m: int, gather, gelu: bool, resid,
                       resid_gather, row_scale, eps: float, form: Optional[int]) -> torch.Tensor:
    """The product on CUDA tensors: the CUDA kernel of `odic::fused_linear`."""
    global launches
    norm = None if norm_w is None else (norm_w, norm_b)
    gather, resid_gather = _gather_of(gather), _gather_of(resid_gather)
    if a.dtype not in _DTYPE_CODE or w.dtype != a.dtype:
        raise ValueError(f"fused_linear: unsupported operands {a.device} {a.dtype} / {w.dtype}")
    kind = None if gather is None else gather[0]
    rkind = None if resid_gather is None else resid_gather[0]
    if (rkind not in (None, "transition")
            or (kind is not None and rkind is not None and gather != resid_gather)):
        raise ValueError(f"fused_linear: unsupported gathers {gather}, {resid_gather}")
    segs = 4 if kind == "merge" else 1
    k, n = w.shape
    if a.shape[-1] * segs != k:
        raise ValueError("fused_linear: a rows must be K / segs wide")
    if form is None:
        form = form_for(a, m, n, k, segs)  # raises outside the kernel's shapes
    if norm is not None and any(t.dtype != torch.float32 or t.shape != (k,) for t in norm):
        raise ValueError("fused_linear: LayerNorm parameters must be fp32 (K,)")
    scale_rows = 1 if row_scale is None else m // row_scale.numel()
    _build.check_cuda_tensors(*[t for t in (a, w, bias, *(norm or ()), resid, row_scale)
                                if t is not None])
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    ln_rows = _ln_scratch(a, m, k) if norm is not None else None
    res, window, delta = next((g[1:] for g in (gather, resid_gather) if g is not None),
                              (0, 0, 0))
    fn = _build.cuda_function(
        "linear", "fused_linear_launch",
        [_P] * 9 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P])
    status = fn(
        a.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(norm and norm[0]), _ptr(norm and norm[1]),
        _ptr(resid), _ptr(row_scale), _ptr(ln_rows), out.data_ptr(), m, n, k, segs, _MAPS[kind],
        _MAPS[rkind], res, window, delta, scale_rows, int(gelu),
        float(eps), form, _DTYPE_CODE[a.dtype], _build.current_stream())
    _build.check_status(status, "fused_linear")
    launches += 1
    return out


_op = _build.define_op(
    "fused_linear",
    "(Tensor a, Tensor w, Tensor? bias, Tensor? norm_w, Tensor? norm_b, int m, int[]? gather, "
    "bool gelu, Tensor? resid, int[]? resid_gather, Tensor? row_scale, float eps, int? form) "
    "-> Tensor",
    _fused_linear_plain, _fused_linear_cuda,
    lambda a, w, bias, norm_w, norm_b, m, *rest: a.new_empty((m, w.shape[1])))


def fused_linear(
    a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
    norm: Optional[Norm] = None, *, m: Optional[int] = None, gather: Optional[Gather] = None,
    gelu: bool = False, resid: Optional[torch.Tensor] = None,
    resid_gather: Optional[Gather] = None, row_scale: Optional[torch.Tensor] = None,
    eps: float = 1e-5, form: Optional[int] = None,
) -> torch.Tensor:
    """The product on (m, N) output rows from the rows of a (rows, K / segs)
    gathered by `gather` (None: row r of a) and w (K, N) in a's dtype; bias
    and the LayerNorm parameters fp32; resid (rows, N) read at the row
    `resid_gather` (None or a transition, on the geometry of `gather` where
    both are given) puts each output row; row_scale fp32 (images,)
    multiplying each image's rounded product before the residual add.
    `odic::fused_linear`: the plain version on CPU tensors, the kernel on
    CUDA tensors, in the tile form of the launch plan unless `form` names one
    (a yardstick's way to compare forms)."""
    for g in (gather, resid_gather):
        if g is not None and g[0] not in _MAPS:
            raise ValueError(f"fused_linear: unsupported gathers {gather}, {resid_gather}")
    norm_w, norm_b = (None, None) if norm is None else norm
    return _op(a, w, bias, norm_w, norm_b, a.shape[0] if m is None else m, _gather_ints(gather),
               gelu, resid, _gather_ints(resid_gather), row_scale, eps, form)


def _grad_operands(a: torch.Tensor, b: torch.Tensor, layout: str):
    """(A, B) of out = A @ B in `layout`: "xw" a @ b, "dywt" a @ b^T, "atb"
    a^T @ b."""
    if layout not in GRAD_LAYOUTS:
        raise ValueError(f"grad_product: unknown layout {layout!r}")
    return (a.t() if layout == "atb" else a), (b.t() if layout == "dywt" else b)


def grad_product_reference(a: torch.Tensor, b: torch.Tensor, layout: str,
                           rounded: bool = False) -> torch.Tensor:
    """A @ B of the stored values summed in fp32 (`_mm` of the plain
    backwards); rounded to a's dtype where `rounded`."""
    x, y = _grad_operands(a, b, layout)
    out = torch.matmul(x.float(), y.float())
    return out.to(a.dtype) if rounded else out


def grad_product(a: torch.Tensor, b: torch.Tensor, layout: str, form: Optional[int] = None,
                 rounded: bool = False) -> torch.Tensor:
    """(M, N) = A @ B in `layout` ("xw": a (M, K) @ b (K, N); "dywt": a (M, K)
    @ b (N, K)^T; "atb": a (K, M)^T @ b (K, N)) of two contiguous matrices of
    one dtype: fp32, or rounded to their dtype where `rounded` (not for
    "atb", whose K the plan splits). CPU tensors get the plain version; CUDA
    tensors the backward product in the launch plan's tile form (or in
    `form`, bf16) and split, its partials summed in order."""
    global grad_launches
    x, y = _grad_operands(a, b, layout)
    if a.device.type == "cpu":
        return grad_product_reference(a, b, layout, rounded)
    if a.device.type != "cuda" or a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"grad_product: unsupported operands {a.device} {a.dtype} / {b.dtype}")
    (m, k), n = x.shape, y.shape[1]
    if y.shape[0] != k:
        raise ValueError(f"grad_product: shapes {tuple(a.shape)} and {tuple(b.shape)} do not "
                         f"meet in layout {layout!r}")
    plan = grad_plan(m, n, k, layout, a.element_size(), sm_count(a.device), form)
    if rounded and plan.splits > 1:
        raise ValueError("grad_product: a split product's sums stay fp32")
    _build.check_cuda_tensors(a, b)
    out = torch.empty((m, n), dtype=a.dtype if rounded else torch.float32, device=a.device)
    part = None if plan.splits == 1 else torch.empty(
        (plan.splits, m, n), dtype=torch.float32, device=a.device)
    fn = _build.cuda_function(
        "linear", "grad_product_launch", [_P] * 4 + [ctypes.c_int] * 10 + [_P])
    status = fn(a.data_ptr(), b.data_ptr(), _ptr(part), out.data_ptr(), m, n, k, a.shape[1],
                b.shape[1], plan.k_chunk, GRAD_LAYOUTS.index(layout), plan.form, int(rounded),
                _DTYPE_CODE[a.dtype],
                _build.current_stream())
    _build.check_status(status, "grad_product")
    grad_launches += 1
    return out
