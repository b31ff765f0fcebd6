"""B12: the int8 product of a w8a8 linear (kernels `csrc/quant_matmul.cu`) and
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
fp32 scale per output channel. On the card a call is two kernels of the
port's own: `quantize_activation` forms s_x and the int8 x once (one launch,
or two for the dynamic scale of a large x), then `int8_product` multiplies
on the int8 tensor cores. `quantize_plan` and `product_plan` pick the form and
the tiles from the shapes alone. The plain versions sum the int8 products
exactly, in float64 (every partial sum is an integer below 2^53; an fp32 sum
of them is not exact above K ~ 1040), on any device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import _build

launches = 0  # product kernel launches since the last reset, one per call (plain calls do not count)
quantize_launches = 0  # launches of the scale / int8 x kernels since the last reset

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
QMAX = 127.0

SMALL_M = 64  # rows up to which the product takes the small-M route
ONE_CTA_VALUES = 1 << 16  # values of x up to which the dynamic scale is formed in one CTA
PARTIALS = 528  # CTAs of the dynamic scale's first pass over a large x (four an SM)
K_SLAB = 64  # k values of one stage of the product's ring
# calibrated scale: one quantizing pass; dynamic: one CTA, or two passes
CALIBRATED, DYNAMIC_ONE_CTA, DYNAMIC_TWO_PASS = 0, 1, 2


def int_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """a_q (M, K) @ b_q (K, N) of int8 values, exact, as int32."""
    return torch.matmul(a_q.double(), b_q.double()).to(torch.int32)


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale max(max|x|, 1e-8) / 127, a 0-d tensor in x's
    dtype, by IEEE division (as JAX divides; a CUDA division by a Python
    number would multiply by a rounded reciprocal instead)."""
    return torch.clamp(x.abs().amax(), min=1e-8) / x.new_full((), QMAX)


def row_scales(h: torch.Tensor) -> torch.Tensor:
    """Per-row scales (R, 1) of fp32 rows h (R, C): max(max|h_r|, 1e-8) / 127."""
    return torch.clamp(h.abs().amax(dim=-1, keepdim=True), min=1e-8) / QMAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(rint(x / scale), -127, 127) as int8, the quotient in the dtype the
    two promote to, as JAX promotes arrays (a 0-d fp32 scale makes a bf16 x's
    quotient fp32, which torch's own rule for 0-d tensors would not)."""
    ct = torch.promote_types(x.dtype, scale.dtype)
    return torch.round(x.to(ct) / scale.to(ct)).clamp(-QMAX, QMAX).to(torch.int8)


def quantize_activation_reference(
    x: torch.Tensor, x_scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 x of x's shape, s_x as a (1,) fp32 tensor): the plain version of
    `quantize_activation`."""
    xs = dynamic_scale(x) if x_scale is None else x_scale
    return quantize(x, xs), xs.reshape(1).float()


def int8_product_reference(
    xq: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """float(xq (M, K) @ w_q^T) * (s_x * w_scale) + bias, (M, N) fp32: the
    plain version of `int8_product`."""
    y = int_matmul(xq, w_q.t()).float() * (s_x.float() * w_scale)
    return y if bias is None else y + bias


def quantized_matmul_reference(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, x_scale: Optional[torch.Tensor] = None,
    xq_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (..., K) fp32 or bf16; w_q (N, K) int8; w_scale (N,) fp32; bias (N,)
    fp32 or None; x_scale a 0-d calibrated scale or None for the dynamic one.
    Returns (..., N) fp32. xq_out, an int8 tensor of x's shape, receives the
    quantized x."""
    xq, s_x = quantize_activation_reference(x, x_scale)
    if xq_out is not None:
        xq_out.copy_(xq)
    k = x.shape[-1]
    y = int8_product_reference(xq.reshape(-1, k), s_x, w_q, w_scale, bias)
    return y.reshape(*x.shape[:-1], w_q.shape[0])


def quantize_plan(numel: int, static: bool) -> int:
    """How the scale and the int8 x are formed: CALIBRATED (one quantizing
    launch), DYNAMIC_ONE_CTA (one launch: a small x, every decode call) or
    DYNAMIC_TWO_PASS (per-CTA maxima whose last CTA forms the scale, then the
    quantizing launch)."""
    if static:
        return CALIBRATED
    return DYNAMIC_ONE_CTA if numel <= ONE_CTA_VALUES else DYNAMIC_TWO_PASS


def quantize_launch_count(numel: int, static: bool) -> int:
    """Kernel launches of one `quantize_activation` call."""
    return 2 if quantize_plan(numel, static) == DYNAMIC_TWO_PASS else 1


def product_route(m: int) -> str:
    """The product's route by its rows alone: "small" up to SMALL_M rows
    (narrow column tiles, K split to fill the card), "large" above."""
    return "small" if m <= SMALL_M else "large"


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    route: str
    mt: int  # fragments of 16 rows per warp
    tile_m: int
    tile_n: int
    tiles: Tuple[int, int]  # (row tiles, column tiles)
    splits: int  # slices of K, each reduced by its own CTA
    k_per_split: int  # a multiple of K_SLAB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def product_plan(m: int, n: int, k: int) -> ProductPlan:
    """Tiles and K split of the product at (M, N, K). Small M: 16, 32 or 64
    rows by 32 columns, K split until about two CTAs an SM (264 on the H100)
    are in flight, at most 16 ways; large M: 64 x 128 tiles, K whole."""
    if product_route(m) == "small":
        mt = 1 if m <= 16 else 2 if m <= 32 else 4
        tile_m, tile_n, target, most = 16 * mt, 32, 264, 16
    else:
        mt, tile_m, tile_n, target, most = 4, 64, 128, 1, 1
    tiles = (_cdiv(m, tile_m), _cdiv(n, tile_n))
    slabs = _cdiv(k, K_SLAB)
    splits = max(1, min(most, slabs, _cdiv(target, tiles[0] * tiles[1])))
    per = _cdiv(slabs, splits)
    return ProductPlan(product_route(m), mt, tile_m, tile_n, tiles, _cdiv(slabs, per),
                       per * K_SLAB)


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the kernels move 16-byte chunks)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


_QUANT_ARGS = (_P, ctypes.c_int, ctypes.c_long, _P) + (ctypes.c_int,) * 3 + (_P,) * 4 + (
    ctypes.c_int, _P)
_PRODUCT_ARGS = (_P,) * 8 + (ctypes.c_int,) * 7 + (_P,)

# device -> (int32 arrival counters: [0] the dynamic scale's, [64:] one per
# output tile of a split product; the dynamic scale's per-CTA maxima; int32
# sums of a split product): the kernels leave counters and sums at zero
_workspace: dict = {}


def _workspace_for(device: torch.device, tiles: int = 0, values: int = 0):
    have = _workspace.get(device)
    if have is None or have[0].shape[0] < 64 + tiles or have[2].shape[0] < values:
        old = (0, 0) if have is None else (have[0].shape[0] - 64, have[2].shape[0])
        have = (torch.zeros((64 + max(tiles, old[0], 4096),), dtype=torch.int32, device=device),
                torch.empty((PARTIALS,), dtype=torch.float32, device=device),
                torch.zeros((max(values, old[1], 1 << 16),), dtype=torch.int32, device=device))
        _workspace[device] = have
    return have


def _quantize_activation_cuda(x2: torch.Tensor, x_scale: Optional[torch.Tensor],
                              xq: torch.Tensor) -> torch.Tensor:
    """Kernel B12's first part on CUDA x2 (M, K): the CUDA kernel of
    `odic::quantize_activation`. Writes the int8 x into xq (M, K) and returns
    s_x as a (1,) fp32 device tensor."""
    global quantize_launches
    if x2.dtype not in _DTYPE_CODE:
        raise ValueError(f"quantized_matmul: x must be fp32 or bf16, got {x2.dtype}")
    if x2.dim() != 2 or x2.shape[1] % 16:
        raise ValueError("quantized_matmul: x must be (M, K), K a multiple of 16 (the "
                         "product's int8 rows)")
    if x_scale is not None and (x_scale.numel() != 1 or x_scale.dtype not in _DTYPE_CODE):
        raise ValueError("quantized_matmul: x_scale must be one fp32 or bf16 value")
    if xq.dtype != torch.int8 or xq.shape != x2.shape:
        raise ValueError("quantized_matmul: xq_out must be int8 of x's shape")
    if x2.numel() == 0:
        raise ValueError("quantized_matmul: x has no rows")
    x2 = aligned(x2)
    form = quantize_plan(x2.numel(), x_scale is not None)
    round_bf16 = x2.dtype == torch.bfloat16 and (x_scale is None or x_scale.dtype == torch.bfloat16)
    counters, partial, _ = _workspace_for(x2.device)
    s_out = torch.empty((1,), dtype=torch.float32, device=x2.device)
    _build.check_cuda_tensors(*[t for t in (x2, x_scale, xq) if t is not None])
    if xq.data_ptr() % 16:
        raise ValueError("quantized_matmul: xq_out must be 16-byte aligned")
    fn = _build.cuda_function("quant_matmul", "quant_act_launch", _QUANT_ARGS)
    status = fn(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], x2.numel(),
        None if x_scale is None else x_scale.data_ptr(),
        int(x_scale is not None and x_scale.dtype == torch.bfloat16), int(round_bf16), form,
        xq.data_ptr(), s_out.data_ptr(), partial.data_ptr(), counters.data_ptr(), PARTIALS,
        _build.current_stream())
    _build.check_status(status, "quant_matmul (quantize)")
    quantize_launches += quantize_launch_count(x2.numel(), x_scale is not None)
    return s_out


def _quantize_activation_plain(x2, x_scale, xq):
    q, s_x = quantize_activation_reference(x2, x_scale)
    xq.copy_(q)
    return s_x.clone()  # a calibrated fp32 (1,) scale comes back as itself


_quantize_op = _build.define_op(
    "quantize_activation", "(Tensor x2, Tensor? x_scale, Tensor(a!) xq) -> Tensor",
    _quantize_activation_plain, _quantize_activation_cuda,
    lambda x2, x_scale, xq: x2.new_empty((1,), dtype=torch.float32))


def quantize_activation(
    x2: torch.Tensor, x_scale: Optional[torch.Tensor], xq: torch.Tensor
) -> torch.Tensor:
    """B12's first part, `odic::quantize_activation`, on x2 (M, K): writes the
    int8 x into xq (M, K) and returns s_x as a (1,) fp32 tensor (the plain
    version on CPU tensors, the kernel on CUDA tensors)."""
    return _quantize_op(x2, x_scale, xq)


def _int8_product_cuda(
    xq: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B12's product on CUDA int8 xq (M, K) with s_x a (1,) fp32
    device tensor: the CUDA kernel of `odic::int8_product`."""
    global launches
    (m, k), n = xq.shape, w_q.shape[0] if w_q.dim() == 2 else -1
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.shape != (n, k) or k % 16:
        raise ValueError("quantized_matmul: w_q must be int8 (N, K), K a multiple of 16")
    if w_scale.dtype != torch.float32 or w_scale.shape != (n,):
        raise ValueError("quantized_matmul: w_scale must be fp32 (N,)")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise ValueError("quantized_matmul: bias must be fp32 (N,)")
    plan = product_plan(m, n, k)
    counters, _, sums = _workspace_for(xq.device, plan.tiles[0] * plan.tiles[1], m * n)
    _build.check_cuda_tensors(*[t for t in (xq, s_x, w_q, w_scale, bias) if t is not None])
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    fn = _build.cuda_function("quant_matmul", "i8_product_launch", _PRODUCT_ARGS)
    status = fn(
        xq.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        sums.data_ptr(), counters[64:].data_ptr(), m, n, k,
        int(plan.route == "large"), plan.mt, plan.splits, plan.k_per_split,
        _build.current_stream())
    _build.check_status(status, "quant_matmul")
    launches += 1
    return out


_product_op = _build.define_op(
    "int8_product",
    "(Tensor xq, Tensor s_x, Tensor w_q, Tensor w_scale, Tensor? bias) -> Tensor",
    int8_product_reference, _int8_product_cuda,
    lambda xq, s_x, w_q, w_scale, bias: s_x.new_empty((xq.shape[0], w_q.shape[0])))


def int8_product(
    xq: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B12's product, `odic::int8_product`, on int8 xq (M, K) with s_x a (1,)
    fp32 tensor: (M, N) fp32, as `int8_product_reference` (the plain version
    on CPU tensors, the kernel on CUDA tensors)."""
    return _product_op(xq, s_x, w_q, w_scale, bias)


def quantized_matmul(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, x_scale: Optional[torch.Tensor] = None,
    xq_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The int8 product (see the module docstring): the int8 x once
    (`quantize_activation`), then the product (`int8_product`); on CPU
    tensors their plain versions, which compose `quantized_matmul_reference`,
    on CUDA tensors kernel B12, which takes K a multiple of 16 and raises on
    anything else it does not take."""
    k, n = x.shape[-1], w_q.shape[0]
    x2 = x.reshape(-1, k)
    if xq_out is not None and (xq_out.dtype != torch.int8 or xq_out.shape != x.shape
                               or not xq_out.is_contiguous()):
        raise ValueError("quantized_matmul: xq_out must be contiguous int8 of x's shape")
    xq = (x2.new_empty(x2.shape, dtype=torch.int8) if xq_out is None
          else xq_out.view(x2.shape))
    s_x = quantize_activation(x2, x_scale, xq)
    return int8_product(xq, s_x, w_q, w_scale, bias).reshape(*x.shape[:-1], n)
