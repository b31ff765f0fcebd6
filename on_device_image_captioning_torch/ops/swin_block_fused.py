"""The whole-block and half-block kernels of the window-resident Swin backbone
and the standalone window transition, each beside its plain version.

Replaces, from `on_device_image_captioning_tpu/ops/swin_block_fused.py`:

- `swin_block_fused` -> `swin_block` (B6, `csrc/swin_block.cu`): the whole
  block in one launch, qkv, the attention output, the post-attention x and
  the MLP hidden activation never leaving the chip;
- `swin_attn_half_fused` -> `swin_attn_half` (B4, `csrc/swin_attn_half.cu`):
  x + proj(window_attention(LN1(x))) on the window layout, optionally reading
  x from the previous block's shift layout;
- `swin_mlp_half_fused` (dense branch) -> `swin_mlp_half` (B5,
  `csrc/swin_mlp_half.cu`): x + fc2(GELU(fc1(LN2(x)))) over flat rows;
- `window_transition_fused` -> `window_transition` (B11,
  `csrc/window_transition.cu`): the permuting copy between two shift layouts;
- `_mlp_half_kernel_a8`, the w8a8 branch of `swin_mlp_half_fused` ->
  `swin_mlp_half_a8` (B13, `csrc/swin_mlp_half_a8.cu`): the MLP half with
  int8 weights and per-row int8 activations.

Operands: weights are (in, out) matrices in x's dtype, prepared once by the
model (`models/swin.py`); LayerNorm parameters, biases, the relative-position
bias (H, N, N) and the shift mask (nW, N, N) are fp32. The plain versions
round where the TPU kernels round (`_ln`, `_linear`, `_attention_rows`,
`_gelu_exact(...).astype`), so bf16 results agree with them to a bf16 ulp;
the one intended difference is the exact erf in GELU (the TPU kernel's
polynomial `_erf`, |err| <= 3e-7, is a Mosaic workaround).

Bounds, designs and launch counts per width: the header of each `.cu`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from . import quant_matmul as qm
from .layernorm import layernorm_reference
from .window_attention import HEAD_DIM
from .window_layout import window_transition_perm

# wrapper calls that launched their kernels since the last reset (plain-version
# calls do not count); one call of B6 is one launch, of B4 a chain of three,
# of B5 two, of B13 three
block_launches = 0
attn_half_launches = 0
mlp_half_launches = 0
mlp_half_a8_launches = 0
transition_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
Norm = Tuple[torch.Tensor, torch.Tensor]  # (scale, bias), fp32
Linear = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (w (in, out) in x.dtype, b fp32 or None)
# (w_q (out, in) int8, per-output-channel scale fp32, b fp32 or None)
QuantLinear = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]
Transition = Tuple[int, int, int]  # (res, from_shift, to_shift)


def linear_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ w + b: products of the stored values summed in fp32, the bias added
    in fp32, the result rounded to x's dtype (the TPU kernels' `_linear`)."""
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _attention_rows_reference(qkv, bias, mask, heads: int, scale: float) -> torch.Tensor:
    """The fused kernels' attention core (`_attention_rows`): q scaled in the
    input dtype, scores and softmax in fp32, exp(s - max) rounded to v's dtype
    before the product with v, division by the fp32 sum after it."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = s.reshape(bw // nw, nw, heads, n, n) + mask.float()[None, :, None]
        s = s.reshape(bw, heads, n, n)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ev = torch.matmul(e.to(v.dtype).float(), v.float())
    out = (ev * (1.0 / e.sum(dim=-1, keepdim=True))).to(qkv.dtype)
    return out.transpose(1, 2).reshape(bw, n, c)


def _window_of(n: int) -> int:
    window = math.isqrt(n)
    if window * window != n:
        raise ValueError(f"a window of {n} tokens is not square")
    return window


def window_transition_reference(
    x: torch.Tensor, res: int, window: int, from_shift: int, to_shift: int
) -> torch.Tensor:
    """(B*nW, n, C) in the from_shift window layout -> the to_shift layout."""
    bw, n, c = x.shape
    perm = torch.from_numpy(window_transition_perm(res, window, from_shift, to_shift))
    flat = x.reshape(bw * n // (res * res), res * res, c)
    return torch.index_select(flat, 1, perm.to(x.device)).reshape(bw, n, c)


def swin_attn_half_reference(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, bias: torch.Tensor,
    mask: Optional[torch.Tensor], heads: int, scale: float, eps: float,
    transition: Optional[Transition] = None,
) -> torch.Tensor:
    if transition is not None:
        res, from_shift, to_shift = transition
        x = window_transition_reference(x, res, _window_of(x.shape[1]), from_shift, to_shift)
    h = layernorm_reference(x, norm1[0], norm1[1], eps)
    h = _attention_rows_reference(linear_reference(h, *qkv), bias, mask, heads, scale)
    return x + linear_reference(h, *proj)


def swin_mlp_half_reference(
    x: torch.Tensor, norm2: Norm, fc1: Linear, fc2: Linear, eps: float
) -> torch.Tensor:
    h = layernorm_reference(x, norm2[0], norm2[1], eps)
    h = linear_reference(h, *fc1)
    h = F.gelu(h.float()).to(h.dtype)  # exact erf, in fp32
    return x + linear_reference(h, *fc2)


def swin_block_reference(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, norm2: Norm, fc1: Linear,
    fc2: Linear, bias: torch.Tensor, mask: Optional[torch.Tensor], heads: int, scale: float,
    eps: float, transition: Optional[Transition] = None,
) -> torch.Tensor:
    """The two halves composed: the TPU kernel's `_block_body` rounds at the
    same places (LN outputs, every product, GELU, both residual sums)."""
    x = swin_attn_half_reference(x, norm1, qkv, proj, bias, mask, heads, scale, eps, transition)
    return swin_mlp_half_reference(x, norm2, fc1, fc2, eps)


def _check_device(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    return True


def _check_norm(name: str, norm: Norm, width: int) -> None:
    if any(t.dtype != torch.float32 or t.shape != (width,) for t in norm):
        raise ValueError(f"{name}: LayerNorm parameters must be fp32 ({width},)")


def _check_linears(name: str, dtype: torch.dtype, *linears: Linear) -> None:
    """(in, out) weights in the activations' dtype whose input width is a
    multiple of the product's K slab (32) and output width of 8 (16-byte
    rows); fp32 biases."""
    for w, b in linears:
        if w.dtype != dtype or w.dim() != 2 or w.shape[0] % 32 or w.shape[1] % 8:
            raise ValueError(
                f"{name}: weights must be (in, out) {dtype}, in a multiple of 32, out of 8")
        if b is not None and (b.dtype != torch.float32 or b.shape != (w.shape[1],)):
            raise ValueError(f"{name}: biases must be fp32 (out,)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _flat(operands):
    return [t for t in operands if t is not None]


def _check_attention(name, x, qkv, proj, bias, mask, heads, transition):
    """What B4 and B6 share: weight shapes, head width, bias and mask, and the
    transition's geometry. Returns (num_windows, res, window, delta)."""
    bw, n, c = x.shape
    if qkv[0].shape != (c, 3 * c) or proj[0].shape != (c, c):
        raise ValueError(f"{name}: qkv must be (C, 3C) and proj (C, C)")
    if c != heads * HEAD_DIM:
        raise ValueError(f"{name}: built for head width {HEAD_DIM}, got {c} / {heads}")
    if bias.dtype != torch.float32 or bias.shape != (heads, n, n):
        raise ValueError(f"{name}: bias must be fp32 (H, N, N)")
    num_windows = 1
    if mask is not None:
        num_windows = mask.shape[0]
        if mask.dtype != torch.float32 or mask.shape[1:] != (n, n) or bw % num_windows:
            raise ValueError(f"{name}: mask must be fp32 (nW, N, N), nW | BW")
    res = window = delta = 0
    if transition is not None:
        res, from_shift, to_shift = transition
        window = _window_of(n)
        if res % window or bw % (res // window) ** 2:
            raise ValueError(f"{name}: x does not tile the transition's grid")
        delta = (to_shift - from_shift) % res
    return num_windows, res, window, delta


BLOCK_TOKENS = 144  # the window B6 is built for
BLOCK_WIDTHS = (192, 384)  # and its widths (Swin-L stages 0 and 1)


def swin_block(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, norm2: Norm, fc1: Linear,
    fc2: Linear, bias: torch.Tensor, mask: Optional[torch.Tensor], heads: int, scale: float,
    eps: float, transition: Optional[Transition] = None,
) -> torch.Tensor:
    """The whole Swin block on window-partitioned x (B*nW, N, C): the
    attention half (see `swin_attn_half`, transition included) and the MLP
    half in one pass. CPU tensors get the plain version; CUDA tensors get
    kernel B6, which is built for windows of 144 tokens, heads of 32 and
    C = 192 or 384, and raises on anything else."""
    global block_launches
    if not _check_device(x, "swin_block"):
        return swin_block_reference(
            x, norm1, qkv, proj, norm2, fc1, fc2, bias, mask, heads, scale, eps, transition)
    bw, n, c = x.shape
    if n != BLOCK_TOKENS or c not in BLOCK_WIDTHS:
        raise ValueError(
            f"swin_block: B6 takes windows of {BLOCK_TOKENS} tokens at C in {BLOCK_WIDTHS}, "
            f"got N={n}, C={c}")
    _check_norm("swin_block", norm1, c)
    _check_norm("swin_block", norm2, c)
    _check_linears("swin_block", x.dtype, qkv, proj, fc1, fc2)
    num_windows, res, window, delta = _check_attention(
        "swin_block", x, qkv, proj, bias, mask, heads, transition)
    hidden = fc1[0].shape[1]
    if fc1[0].shape[0] != c or fc2[0].shape != (hidden, c) or hidden % 96:
        raise ValueError(
            "swin_block: fc1 must be (C, hidden) and fc2 (hidden, C), hidden a multiple of 96")
    _build.check_cuda_tensors(
        *_flat([x, *norm1, *qkv, *proj, *norm2, *fc1, *fc2, bias, mask]))
    out = torch.empty_like(x)
    fn = _build.cuda_function(
        "swin_block", "swin_block_launch",
        [_P] * 16 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [_P],
    )
    status = fn(
        x.data_ptr(), norm1[0].data_ptr(), norm1[1].data_ptr(),
        qkv[0].data_ptr(), _ptr(qkv[1]), proj[0].data_ptr(), _ptr(proj[1]),
        norm2[0].data_ptr(), norm2[1].data_ptr(),
        fc1[0].data_ptr(), _ptr(fc1[1]), fc2[0].data_ptr(), _ptr(fc2[1]),
        bias.data_ptr(), _ptr(mask), out.data_ptr(),
        bw, n, c, heads, hidden, num_windows, float(scale), float(eps),
        int(transition is not None), res, window, delta, _DTYPE_CODE[x.dtype],
        _build.current_stream(),
    )
    _build.check_status(status, "swin_block")
    block_launches += 1
    return out


def swin_attn_half(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, bias: torch.Tensor,
    mask: Optional[torch.Tensor], heads: int, scale: float, eps: float,
    transition: Optional[Transition] = None,
) -> torch.Tensor:
    """x + proj(window_attention(LN1(x))) on window-partitioned x (B*nW, N, C).
    transition = (res, from_shift, to_shift) reads x from the from_shift
    layout; the result and the mask are in the to_shift layout. CPU tensors
    get the plain version; CUDA tensors get kernel B4."""
    global attn_half_launches
    args = (x, norm1, qkv, proj, bias, mask, heads, scale, eps, transition)
    if not _check_device(x, "swin_attn_half"):
        return swin_attn_half_reference(*args)
    bw, n, c = x.shape
    _check_norm("swin_attn_half", norm1, c)
    _check_linears("swin_attn_half", x.dtype, qkv, proj)
    num_windows, res, window, delta = _check_attention(
        "swin_attn_half", x, qkv, proj, bias, mask, heads, transition)
    if 2 * n * HEAD_DIM * 4 > 48 * 1024:
        raise ValueError(f"swin_attn_half: window of {n} tokens exceeds shared memory")
    _build.check_cuda_tensors(*_flat([x, *norm1, *qkv, *proj, bias, mask]))
    qkv_buf = torch.empty((bw, n, 3 * c), dtype=x.dtype, device=x.device)
    attn_buf = torch.empty_like(x)
    out = torch.empty_like(x)
    fn = _build.cuda_function(
        "swin_attn_half", "swin_attn_half_launch",
        [_P] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [_P],
    )
    status = fn(
        x.data_ptr(), norm1[0].data_ptr(), norm1[1].data_ptr(),
        qkv[0].data_ptr(), _ptr(qkv[1]), proj[0].data_ptr(), _ptr(proj[1]),
        bias.data_ptr(), _ptr(mask), qkv_buf.data_ptr(), attn_buf.data_ptr(), out.data_ptr(),
        bw, n, c, heads, num_windows, float(scale), float(eps),
        int(transition is not None), res, window, delta, _DTYPE_CODE[x.dtype],
        _build.current_stream(),
    )
    _build.check_status(status, "swin_attn_half")
    attn_half_launches += 1
    return out


def swin_mlp_half(
    x: torch.Tensor, norm2: Norm, fc1: Linear, fc2: Linear, eps: float
) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN2(x)))) over the rows of x (..., C): position-wise,
    so any layout. CPU tensors get the plain version; CUDA tensors get
    kernel B5."""
    global mlp_half_launches
    if not _check_device(x, "swin_mlp_half"):
        return swin_mlp_half_reference(x, norm2, fc1, fc2, eps)
    c = x.shape[-1]
    rows = x.numel() // c
    _check_norm("swin_mlp_half", norm2, c)
    _check_linears("swin_mlp_half", x.dtype, fc1, fc2)
    hidden = fc1[0].shape[1]
    if fc1[0].shape[0] != c or fc2[0].shape != (hidden, c):
        raise ValueError("swin_mlp_half: fc1 must be (C, hidden) and fc2 (hidden, C)")
    _build.check_cuda_tensors(*_flat([x, *norm2, *fc1, *fc2]))
    hidden_buf = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = _build.cuda_function(
        "swin_mlp_half", "swin_mlp_half_launch",
        [_P] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, _P],
    )
    status = fn(
        x.data_ptr(), norm2[0].data_ptr(), norm2[1].data_ptr(),
        fc1[0].data_ptr(), _ptr(fc1[1]), fc2[0].data_ptr(), _ptr(fc2[1]),
        hidden_buf.data_ptr(), out.data_ptr(), rows, c, hidden, float(eps),
        _DTYPE_CODE[x.dtype], _build.current_stream(),
    )
    _build.check_status(status, "swin_mlp_half")
    mlp_half_launches += 1
    return out


def _int8_linear_reference(hq: torch.Tensor, hs: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """acc * (hs * s) + b in fp32 for int8 rows hq with row scales hs (R, 1)."""
    w_q, s, b = lin
    y = qm.int_matmul(hq, w_q.t()).float() * (hs * s)
    return y if b is None else y + b


def swin_mlp_half_a8_reference(
    x: torch.Tensor, norm2: Norm, fc1: QuantLinear, fc2: QuantLinear, eps: float,
    hidden: bool = False,
):
    """The TPU kernel's `_mlp_half_kernel_a8`: LN2 rounded to x's dtype, per-row
    int8, int8 fc1, fp32 GELU of the unrounded value, per-row int8, int8 fc2,
    and x + fc2 in x's dtype. hidden=True also returns the int8 rows the two
    products read: LN2's (R, C) and the hidden (R, 4C)."""
    c = x.shape[-1]
    h = layernorm_reference(x, norm2[0], norm2[1], eps).float().reshape(-1, c)
    hs = qm.row_scales(h)
    hq = qm.quantize(h, hs)
    y = F.gelu(_int8_linear_reference(hq, hs, fc1))  # exact erf, fp32
    ys = qm.row_scales(y)
    yq = qm.quantize(y, ys)
    out = x + _int8_linear_reference(yq, ys, fc2).to(x.dtype).reshape(x.shape)
    return (out, hq, yq) if hidden else out


def _check_quant_linears(name: str, c: int, fc1: QuantLinear, fc2: QuantLinear) -> int:
    hid = fc1[0].shape[0]
    for (w_q, s, b), shape in ((fc1, (hid, c)), (fc2, (c, hid))):
        if w_q.dtype != torch.int8 or w_q.shape != shape:
            raise ValueError(f"{name}: fc1 must be int8 (hidden, C) and fc2 int8 (C, hidden)")
        if s.dtype != torch.float32 or s.shape != shape[:1]:
            raise ValueError(f"{name}: scales must be fp32 (out,)")
        if b is not None and (b.dtype != torch.float32 or b.shape != shape[:1]):
            raise ValueError(f"{name}: biases must be fp32 (out,)")
    if c % 16 or hid % 16:
        raise ValueError(f"{name}: C and hidden must be multiples of 16")
    return hid


def swin_mlp_half_a8(
    x: torch.Tensor, norm2: Norm, fc1: QuantLinear, fc2: QuantLinear, eps: float,
    hidden: bool = False,
):
    """x + fc2(GELU(fc1(LN2(x)))) over the rows of x (..., C) with int8 weights
    and per-row int8 activations (a w8a8 block's MLP half). CPU tensors get the
    plain version; CUDA tensors get kernel B13. hidden=True also returns the
    int8 rows the two products read, LN2's and the hidden (on the card the
    latter formed from the fp32 hidden and its row maxima exactly as the third
    launch forms them; for checks)."""
    global mlp_half_a8_launches
    if not _check_device(x, "swin_mlp_half_a8"):
        return swin_mlp_half_a8_reference(x, norm2, fc1, fc2, eps, hidden)
    c = x.shape[-1]
    rows = x.numel() // c
    _check_norm("swin_mlp_half_a8", norm2, c)
    hid = _check_quant_linears("swin_mlp_half_a8", c, fc1, fc2)
    x = qm.aligned(x)
    _build.check_cuda_tensors(*_flat([x, *norm2, *fc1, *fc2]))
    dev = x.device
    xq = torch.empty((rows, c), dtype=torch.int8, device=dev)
    xs = torch.empty((rows,), dtype=torch.float32, device=dev)
    hidden_buf = torch.empty((rows, hid), dtype=torch.float32, device=dev)
    hmax = torch.empty((rows,), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    fn = _build.cuda_function(
        "swin_mlp_half_a8", "swin_mlp_half_a8_launch",
        [_P] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, _P],
    )
    status = fn(
        x.data_ptr(), norm2[0].data_ptr(), norm2[1].data_ptr(),
        fc1[0].data_ptr(), fc1[1].data_ptr(), _ptr(fc1[2]),
        fc2[0].data_ptr(), fc2[1].data_ptr(), _ptr(fc2[2]),
        xq.data_ptr(), xs.data_ptr(), hidden_buf.data_ptr(), hmax.data_ptr(), out.data_ptr(),
        rows, c, hid, float(eps), _DTYPE_CODE[x.dtype], _build.current_stream(),
    )
    _build.check_status(status, "swin_mlp_half_a8")
    mlp_half_a8_launches += 1
    if hidden:
        scale = torch.clamp(hmax, min=1e-8)[:, None] / qm.QMAX
        return out, xq, qm.quantize(hidden_buf, scale)
    return out


def window_transition(
    x: torch.Tensor, res: int, window: int, from_shift: int, to_shift: int
) -> torch.Tensor:
    """(B*nW, n, C) in the from_shift window layout of a (res, res) grid ->
    the to_shift layout. CPU tensors get the plain version; CUDA tensors get
    kernel B11."""
    global transition_launches
    if not _check_device(x, "window_transition"):
        return window_transition_reference(x, res, window, from_shift, to_shift)
    bw, n, c = x.shape
    row_bytes = c * x.element_size()
    if n != window * window or res % window or (bw * n) % (res * res) or row_bytes % 16:
        raise ValueError("window_transition: x must be (B*nW, window^2, C) with 16-byte rows")
    _build.check_cuda_tensors(x)
    out = torch.empty_like(x)
    fn = _build.cuda_function(
        "window_transition", "window_transition_launch",
        [_P, _P, ctypes.c_long] + [ctypes.c_int] * 4 + [_P],
    )
    status = fn(
        x.data_ptr(), out.data_ptr(), bw * n, row_bytes, res, window,
        (to_shift - from_shift) % res, _build.current_stream(),
    )
    _build.check_status(status, "window_transition")
    transition_launches += 1
    return out


# ---------------------------------------------------------------------------
# Training: forwards with per-image stochastic-depth scales, and backwards
# that recompute the block's internals from the saved x (and x2).
#
# Replaces, from `on_device_image_captioning_tpu/ops/swin_block_fused.py`:
#
# - `_train_fwd_call` -> `swin_block_train` forward (B9a, second entry of
#   `csrc/swin_block.cu`): the whole block with scales m1, m2 on the two
#   branches, returning (y, x2), x2 the mid-block residual rounded to the
#   storage type before LN2 reads it;
# - `_attn_half_train_fwd_call` -> `swin_attn_half_train` forward (B10a,
#   `csrc/swin_attn_half.cu`) and `_mlp_half_train_fwd_call` ->
#   `swin_mlp_half_train` forward (B10b, `csrc/swin_mlp_half.cu`);
# - `_attn_bwd_call` / `_attn_bwd_call_emit` -> `swin_attn_bwd` (B9b,
#   `csrc/swin_attn_bwd.cu`) and `_mlp_bwd_call` / `_mlp_bwd_call_emit` ->
#   `swin_mlp_bwd` (B9c, `csrc/swin_mlp_bwd.cu`): each pair is one function in
#   two TPU forms, one kernel here.
#
# The scales are per image, (B,) fp32 with B = BW / windows per image: window
# w (row r) takes the scale of image w // windows_per_image. A linear operand
# is (w (in, out), b or None) in any float dtype: fp32 master weights are cast
# to x's dtype once per call of an autograd function, in its forward, and the
# cast copy is kept for the backward. Gradients come back in fp32 and are cast
# to each parameter's dtype; mask and scales get none.
# ---------------------------------------------------------------------------

block_train_launches = 0
attn_half_train_launches = 0
mlp_half_train_launches = 0
attn_bwd_launches = 0
mlp_bwd_launches = 0


def _check_per_image_scales(name: str, x: torch.Tensor, *scales: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> int:
    """Every scale must be fp32 (B,) with B dividing x's leading dimension
    into whole images (the drop-path contract: one value per image; with a
    shift mask an image is a multiple of the mask's nW windows). Returns B."""
    b = scales[0].shape[0] if scales[0].dim() == 1 else -1
    per_image = x.shape[0] // b if b > 0 else 0
    for m in scales:
        if m.dim() != 1 or m.shape[0] != b or b <= 0 or x.shape[0] % b or (
                mask is not None and per_image % mask.shape[0]):
            raise ValueError(
                f"{name}: stochastic-depth scales must be per image, (B,) with B dividing "
                f"{x.shape[0]} into whole images; got {tuple(m.shape)}")
        if m.dtype != torch.float32:
            raise ValueError(f"{name}: stochastic-depth scales must be fp32")
    return b


def _scaled_residual(x: torch.Tensor, branch: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x + m[image] * branch in fp32, rounded to x's dtype (the rounded branch
    is scaled, then added: `_block_kernel_train`)."""
    b = m.shape[0]
    y = x.float().reshape(b, -1) + m.float()[:, None] * branch.float().reshape(b, -1)
    return y.to(x.dtype).reshape(x.shape)


def swin_attn_half_train_reference(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, bias: torch.Tensor,
    mask: Optional[torch.Tensor], m1: torch.Tensor, heads: int, scale: float, eps: float,
) -> torch.Tensor:
    h = layernorm_reference(x, norm1[0], norm1[1], eps)
    h = _attention_rows_reference(linear_reference(h, *qkv), bias, mask, heads, scale)
    return _scaled_residual(x, linear_reference(h, *proj), m1)


def swin_mlp_half_train_reference(
    x2: torch.Tensor, norm2: Norm, fc1: Linear, fc2: Linear, m2: torch.Tensor, eps: float
) -> torch.Tensor:
    h = layernorm_reference(x2, norm2[0], norm2[1], eps)
    h = linear_reference(h, *fc1)
    h = F.gelu(h.float()).to(h.dtype)
    return _scaled_residual(x2, linear_reference(h, *fc2), m2)


def swin_block_train_reference(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, norm2: Norm, fc1: Linear,
    fc2: Linear, bias: torch.Tensor, mask: Optional[torch.Tensor], m1: torch.Tensor,
    m2: torch.Tensor, heads: int, scale: float, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, x2): LN2 and the second residual read the rounded x2."""
    x2 = swin_attn_half_train_reference(x, norm1, qkv, proj, bias, mask, m1, heads, scale, eps)
    return swin_mlp_half_train_reference(x2, norm2, fc1, fc2, m2, eps), x2


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Products of the stored values summed in fp32."""
    return torch.matmul(a.float(), b.float())


def _ln_stats(x: torch.Tensor, eps: float):
    """fp32 (xhat, rstd) of x over the last dim."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def _ln_bwd(dy_n: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor, gamma: torch.Tensor):
    """LayerNorm backward over rows (R, C) in fp32: (dx, dgamma, dbeta) from
    the gradient of the LayerNorm output (`_ln_bwd` of the TPU kernels)."""
    dgamma = (dy_n * xhat).sum(dim=0)
    dbeta = dy_n.sum(dim=0)
    dxhat = dy_n * gamma.float()
    mean1 = dxhat.mean(dim=-1, keepdim=True)
    mean2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - mean1 - xhat * mean2), dgamma, dbeta


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact GELU in fp32: Phi(h) + h phi(h)."""
    return 0.5 * (1.0 + torch.erf(h * 0.7071067811865476)) + h * torch.exp(
        -0.5 * h * h) * 0.3989422804014327


def _rows_scale(m: torch.Tensor, rows: int) -> torch.Tensor:
    """(B,) per-image scales -> (rows, 1), rows image-major."""
    return m.float().repeat_interleave(rows // m.shape[0])[:, None]


def swin_mlp_bwd_reference(
    x2: torch.Tensor, dy: torch.Tensor, norm2: Norm, fc1: Linear, fc2: Linear,
    m2: torch.Tensor, eps: float,
):
    """Backward of the MLP half from the saved x2 and dy, written out step by
    step with the TPU kernel's roundings (`_mlp_bwd_kernel`): h1 stays fp32;
    g, dmlp (rounded after the scale) and dh1 are rounded to x2's dtype before
    they enter a product; bias and LayerNorm gradients sum fp32 values.
    Returns (dx2, dg2, dbe2, dw1, db1, dw2, db2), all but dx2 fp32."""
    cd, c = x2.dtype, x2.shape[-1]
    x2f, dyf = x2.reshape(-1, c), dy.reshape(-1, c)
    (w1, b1), (w2, _) = fc1, fc2
    xhat, rstd = _ln_stats(x2f, eps)
    xn2 = (xhat * norm2[0].float() + norm2[1].float()).to(cd)
    h1 = _mm(xn2, w1)
    if b1 is not None:
        h1 = h1 + b1.float()
    g = F.gelu(h1).to(cd)
    dmlp = (dyf.float() * _rows_scale(m2, x2f.shape[0])).to(cd)
    dw2 = _mm(g.t(), dmlp)
    db2 = dmlp.float().sum(dim=0)
    dh1 = (_mm(dmlp, w2.t()) * _gelu_grad(h1)).to(cd)
    dw1 = _mm(xn2.t(), dh1)
    db1 = dh1.float().sum(dim=0)
    dx_ln, dg2, dbe2 = _ln_bwd(_mm(dh1, w1.t()), xhat, rstd, norm2[0])
    dx2 = (dyf.float() + dx_ln).to(cd).reshape(x2.shape)
    return dx2, dg2, dbe2, dw1, db1, dw2, db2


def swin_attn_bwd_reference(
    x: torch.Tensor, dx2: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear,
    bias: torch.Tensor, mask: Optional[torch.Tensor], m1: torch.Tensor, heads: int,
    scale: float, eps: float,
):
    """Backward of the attention half from the saved x and dx2, written out
    step by step with the TPU kernel's roundings (`_attn_bwd_kernel`): q * scale
    is a product in x's dtype by the scale rounded to it; dproj is rounded after
    the scale; p, ds, dao and dqkv are rounded before they enter a product while
    dbias and dbqkv sum the fp32 values; dq is scaled after its product; the
    attention rows that feed dWproj are the forward's (e . v) * inv form.
    Returns (dx, dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias), all but dx
    fp32."""
    cd = x.dtype
    bw, n, c = x.shape
    dk = c // heads
    (wqkv, bqkv), (wproj, _) = qkv, proj
    xf, dx2f = x.reshape(-1, c), dx2.reshape(-1, c)
    xhat, rstd = _ln_stats(xf, eps)
    xn1 = (xhat * norm1[0].float() + norm1[1].float()).to(cd)
    qkv_a = linear_reference(xn1, wqkv, bqkv).reshape(bw, n, 3 * c)
    attn = _attention_rows_reference(qkv_a, bias, mask, heads, scale).reshape(-1, c)

    dproj = (dx2f.float() * _rows_scale(m1, xf.shape[0])).to(cd)
    dbproj = dproj.float().sum(dim=0)
    dwproj = _mm(attn.t(), dproj)
    dao = _mm(dproj, wproj.t()).to(cd).reshape(bw, n, heads, dk).transpose(1, 2)

    q, k, v = qkv_a.reshape(bw, n, 3, heads, dk).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(scale, dtype=cd)
    s = _mm(q, k.transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n) + mask.float()[None, :, None]).reshape(
            bw, heads, n, n)
    p = torch.softmax(s, dim=-1)
    dp = _mm(dao, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=0)
    ds_cd, p_cd = ds.to(cd), p.to(cd)
    dq = _mm(ds_cd, k) * scale
    dk_ = _mm(ds_cd.transpose(-1, -2), q)
    dv = _mm(p_cd.transpose(-1, -2), dao)
    # (3, BW, H, N, dk) -> rows of [q (C) | k (C) | v (C)], heads inside each
    dqkv = torch.stack([dq, dk_, dv]).permute(1, 3, 0, 2, 4).reshape(-1, 3 * c)
    dbqkv = dqkv.sum(dim=0)
    dqkv_cd = dqkv.to(cd)
    dwqkv = _mm(xn1.t(), dqkv_cd)
    dx_ln, dg1, dbe1 = _ln_bwd(_mm(dqkv_cd, wqkv.t()), xhat, rstd, norm1[0])
    dx = (dx2f.float() + dx_ln).to(cd).reshape(x.shape)
    return dx, dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias


def _zeros_like_all(device, *shapes):
    """fp32 zeros of the given shapes, carved out of one zeroed buffer (the
    backward kernels add into their outputs)."""
    sizes = [math.prod(s) for s in shapes]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
    return [t.reshape(s) for t, s in zip(buf.split(sizes), shapes)]


def swin_block_train_forward(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, norm2: Norm, fc1: Linear,
    fc2: Linear, bias: torch.Tensor, mask: Optional[torch.Tensor], m1: torch.Tensor,
    m2: torch.Tensor, heads: int, scale: float, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, x2) of the whole block with scales. CPU tensors get the plain
    version; CUDA tensors get kernel B9a (windows of 144 tokens, C = 192 or
    384) or raise. No gradient: `swin_block_train` is the differentiable
    form."""
    global block_train_launches
    b = _check_per_image_scales("swin_block_train", x, m1, m2, mask=mask)
    args = (x, norm1, qkv, proj, norm2, fc1, fc2, bias, mask, m1, m2, heads, scale, eps)
    if not _check_device(x, "swin_block_train"):
        return swin_block_train_reference(*args)
    bw, n, c = x.shape
    if n != BLOCK_TOKENS or c not in BLOCK_WIDTHS:
        raise ValueError(
            f"swin_block_train: B9a takes windows of {BLOCK_TOKENS} tokens at C in "
            f"{BLOCK_WIDTHS}, got N={n}, C={c}")
    _check_norm("swin_block_train", norm1, c)
    _check_norm("swin_block_train", norm2, c)
    _check_linears("swin_block_train", x.dtype, qkv, proj, fc1, fc2)
    num_windows = _check_attention("swin_block_train", x, qkv, proj, bias, mask, heads, None)[0]
    hidden = fc1[0].shape[1]
    if fc1[0].shape[0] != c or fc2[0].shape != (hidden, c) or hidden % 96:
        raise ValueError(
            "swin_block_train: fc1 must be (C, hidden) and fc2 (hidden, C), hidden a "
            "multiple of 96")
    _build.check_cuda_tensors(
        *_flat([x, *norm1, *qkv, *proj, *norm2, *fc1, *fc2, bias, mask, m1, m2]))
    out, x2 = torch.empty_like(x), torch.empty_like(x)
    fn = _build.cuda_function(
        "swin_block", "swin_block_train_launch",
        [_P] * 19 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_int, _P],
    )
    status = fn(
        x.data_ptr(), norm1[0].data_ptr(), norm1[1].data_ptr(),
        qkv[0].data_ptr(), _ptr(qkv[1]), proj[0].data_ptr(), _ptr(proj[1]),
        norm2[0].data_ptr(), norm2[1].data_ptr(),
        fc1[0].data_ptr(), _ptr(fc1[1]), fc2[0].data_ptr(), _ptr(fc2[1]),
        bias.data_ptr(), _ptr(mask), m1.data_ptr(), m2.data_ptr(), x2.data_ptr(),
        out.data_ptr(), bw, n, c, heads, hidden, num_windows, bw // b,
        float(scale), float(eps), _DTYPE_CODE[x.dtype], _build.current_stream(),
    )
    _build.check_status(status, "swin_block_train")
    block_train_launches += 1
    return out, x2


def swin_attn_half_train_forward(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, bias: torch.Tensor,
    mask: Optional[torch.Tensor], m1: torch.Tensor, heads: int, scale: float, eps: float,
) -> torch.Tensor:
    """x + m1 * proj(window_attention(LN1(x))). CPU tensors get the plain
    version; CUDA tensors get kernel B10a or raise. No gradient."""
    global attn_half_train_launches
    b = _check_per_image_scales("swin_attn_half_train", x, m1, mask=mask)
    if not _check_device(x, "swin_attn_half_train"):
        return swin_attn_half_train_reference(
            x, norm1, qkv, proj, bias, mask, m1, heads, scale, eps)
    bw, n, c = x.shape
    _check_norm("swin_attn_half_train", norm1, c)
    _check_linears("swin_attn_half_train", x.dtype, qkv, proj)
    num_windows = _check_attention(
        "swin_attn_half_train", x, qkv, proj, bias, mask, heads, None)[0]
    if 2 * n * HEAD_DIM * 4 > 48 * 1024:
        raise ValueError(f"swin_attn_half_train: window of {n} tokens exceeds shared memory")
    _build.check_cuda_tensors(*_flat([x, *norm1, *qkv, *proj, bias, mask, m1]))
    qkv_buf = torch.empty((bw, n, 3 * c), dtype=x.dtype, device=x.device)
    attn_buf = torch.empty_like(x)
    out = torch.empty_like(x)
    fn = _build.cuda_function(
        "swin_attn_half", "swin_attn_half_train_launch",
        [_P] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int, _P],
    )
    status = fn(
        x.data_ptr(), norm1[0].data_ptr(), norm1[1].data_ptr(),
        qkv[0].data_ptr(), _ptr(qkv[1]), proj[0].data_ptr(), _ptr(proj[1]),
        bias.data_ptr(), _ptr(mask), m1.data_ptr(), qkv_buf.data_ptr(), attn_buf.data_ptr(),
        out.data_ptr(), bw, n, c, heads, num_windows, bw // b, float(scale), float(eps),
        _DTYPE_CODE[x.dtype], _build.current_stream(),
    )
    _build.check_status(status, "swin_attn_half_train")
    attn_half_train_launches += 1
    return out


def swin_mlp_half_train_forward(
    x2: torch.Tensor, norm2: Norm, fc1: Linear, fc2: Linear, m2: torch.Tensor, eps: float
) -> torch.Tensor:
    """x2 + m2 * fc2(GELU(fc1(LN2(x2)))) over x2 (B*k, ..., C), rows
    image-major. CPU tensors get the plain version; CUDA tensors get kernel
    B10b or raise. No gradient."""
    global mlp_half_train_launches
    b = _check_per_image_scales("swin_mlp_half_train", x2, m2)
    if not _check_device(x2, "swin_mlp_half_train"):
        return swin_mlp_half_train_reference(x2, norm2, fc1, fc2, m2, eps)
    c = x2.shape[-1]
    rows = x2.numel() // c
    _check_norm("swin_mlp_half_train", norm2, c)
    _check_linears("swin_mlp_half_train", x2.dtype, fc1, fc2)
    hidden = fc1[0].shape[1]
    if fc1[0].shape[0] != c or fc2[0].shape != (hidden, c):
        raise ValueError("swin_mlp_half_train: fc1 must be (C, hidden) and fc2 (hidden, C)")
    _build.check_cuda_tensors(*_flat([x2, *norm2, *fc1, *fc2, m2]))
    hidden_buf = torch.empty((rows, hidden), dtype=x2.dtype, device=x2.device)
    out = torch.empty_like(x2)
    fn = _build.cuda_function(
        "swin_mlp_half", "swin_mlp_half_train_launch",
        [_P] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, _P],
    )
    status = fn(
        x2.data_ptr(), norm2[0].data_ptr(), norm2[1].data_ptr(),
        fc1[0].data_ptr(), _ptr(fc1[1]), fc2[0].data_ptr(), _ptr(fc2[1]), m2.data_ptr(),
        hidden_buf.data_ptr(), out.data_ptr(), rows, c, hidden, rows // b, float(eps),
        _DTYPE_CODE[x2.dtype], _build.current_stream(),
    )
    _build.check_status(status, "swin_mlp_half_train")
    mlp_half_train_launches += 1
    return out


def swin_mlp_bwd(
    x2: torch.Tensor, dy: torch.Tensor, norm2: Norm, fc1: Linear, fc2: Linear,
    m2: torch.Tensor, eps: float,
):
    """(dx2, dg2, dbe2, dw1, db1, dw2, db2) of the MLP half from the saved x2
    and dy; weights (in, out) in x2's dtype. CPU tensors get the plain
    version; CUDA tensors get kernel B9c or raise."""
    global mlp_bwd_launches
    b = _check_per_image_scales("swin_mlp_bwd", x2, m2)
    if not _check_device(x2, "swin_mlp_bwd"):
        return swin_mlp_bwd_reference(x2, dy, norm2, fc1, fc2, m2, eps)
    c = x2.shape[-1]
    rows = x2.numel() // c
    if dy.shape != x2.shape or dy.dtype != x2.dtype:
        raise ValueError("swin_mlp_bwd: dy must have x2's shape and dtype")
    _check_norm("swin_mlp_bwd", norm2, c)
    _check_linears("swin_mlp_bwd", x2.dtype, fc1, fc2)
    hidden = fc1[0].shape[1]
    if fc1[0].shape[0] != c or fc2[0].shape != (hidden, c) or c > 1024 or c % 8 or hidden % 8:
        raise ValueError(
            "swin_mlp_bwd: fc1 must be (C, hidden) and fc2 (hidden, C), C at most 1024, both "
            "widths multiples of 8")
    _build.check_cuda_tensors(*_flat([x2, dy, *norm2, *fc1, fc2[0], m2]))
    dev, cd = x2.device, x2.dtype
    xn2, dmlp, dx2 = (torch.empty((rows, c), dtype=cd, device=dev) for _ in range(3))
    g, dh1 = (torch.empty((rows, hidden), dtype=cd, device=dev) for _ in range(2))
    h1 = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    dxn2 = torch.empty((rows, c), dtype=torch.float32, device=dev)
    dw1, db1, dw2, db2, dg2, dbe2 = _zeros_like_all(
        dev, (c, hidden), (hidden,), (hidden, c), (c,), (c,), (c,))
    fn = _build.cuda_function(
        "swin_mlp_bwd", "swin_mlp_bwd_launch",
        [_P] * 21 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, _P],
    )
    status = fn(
        x2.data_ptr(), dy.data_ptr(), norm2[0].data_ptr(), norm2[1].data_ptr(),
        fc1[0].data_ptr(), _ptr(fc1[1]), fc2[0].data_ptr(), m2.data_ptr(),
        xn2.data_ptr(), h1.data_ptr(), g.data_ptr(), dmlp.data_ptr(), dh1.data_ptr(),
        dxn2.data_ptr(), dx2.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
        db2.data_ptr(), dg2.data_ptr(), dbe2.data_ptr(), rows, c, hidden, rows // b,
        float(eps), _DTYPE_CODE[cd], _build.current_stream(),
    )
    _build.check_status(status, "swin_mlp_bwd")
    mlp_bwd_launches += 1
    return dx2.reshape(x2.shape), dg2, dbe2, dw1, db1, dw2, db2


def swin_attn_bwd(
    x: torch.Tensor, dx2: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear,
    bias: torch.Tensor, mask: Optional[torch.Tensor], m1: torch.Tensor, heads: int,
    scale: float, eps: float,
):
    """(dx, dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias) of the attention
    half from the saved x and dx2; weights (in, out) in x's dtype. CPU tensors
    get the plain version; CUDA tensors get kernel B9b or raise."""
    global attn_bwd_launches
    b = _check_per_image_scales("swin_attn_bwd", x, m1, mask=mask)
    if not _check_device(x, "swin_attn_bwd"):
        return swin_attn_bwd_reference(
            x, dx2, norm1, qkv, proj, bias, mask, m1, heads, scale, eps)
    bw, n, c = x.shape
    if dx2.shape != x.shape or dx2.dtype != x.dtype:
        raise ValueError("swin_attn_bwd: dx2 must have x's shape and dtype")
    _check_norm("swin_attn_bwd", norm1, c)
    _check_linears("swin_attn_bwd", x.dtype, qkv, proj)
    num_windows = _check_attention("swin_attn_bwd", x, qkv, proj, bias, mask, heads, None)[0]
    if (2 * n * (n + 1) + 2 * n * (HEAD_DIM + 1)) * 4 > 227 * 1024 or c > 1024:
        raise ValueError(
            f"swin_attn_bwd: window of {n} tokens at C={c} exceeds shared memory")
    _build.check_cuda_tensors(*_flat([x, dx2, *norm1, *qkv, proj[0], bias, mask, m1]))
    dev, cd = x.device, x.dtype
    rows = bw * n
    xn1, attn, dproj, dao, dx = (torch.empty((rows, c), dtype=cd, device=dev) for _ in range(5))
    qkv_buf = torch.empty((rows, 3 * c), dtype=cd, device=dev)
    dqkv = torch.empty((rows, 3 * c), dtype=torch.float32, device=dev)
    dqkv_t = None if cd == torch.float32 else torch.empty((rows, 3 * c), dtype=cd, device=dev)
    dxn1 = torch.empty((rows, c), dtype=torch.float32, device=dev)
    dwqkv, dbqkv, dwproj, dbproj, dg1, dbe1, dbias = _zeros_like_all(
        dev, (c, 3 * c), (3 * c,), (c, c), (c,), (c,), (c,), (heads, n, n))
    fn = _build.cuda_function(
        "swin_attn_bwd", "swin_attn_bwd_launch",
        [_P] * 26 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int, _P],
    )
    status = fn(
        x.data_ptr(), dx2.data_ptr(), norm1[0].data_ptr(), norm1[1].data_ptr(),
        qkv[0].data_ptr(), _ptr(qkv[1]), proj[0].data_ptr(), bias.data_ptr(), _ptr(mask),
        m1.data_ptr(), xn1.data_ptr(), qkv_buf.data_ptr(), attn.data_ptr(), dproj.data_ptr(),
        dao.data_ptr(), dqkv.data_ptr(), _ptr(dqkv_t), dxn1.data_ptr(), dx.data_ptr(),
        dwqkv.data_ptr(), dbqkv.data_ptr(), dwproj.data_ptr(), dbproj.data_ptr(),
        dg1.data_ptr(), dbe1.data_ptr(), dbias.data_ptr(), bw, n, c, heads, num_windows,
        bw // b, float(scale), float(eps), _DTYPE_CODE[cd], _build.current_stream(),
    )
    _build.check_status(status, "swin_attn_bwd")
    attn_bwd_launches += 1
    return dx.reshape(x.shape), dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias


def _compute_operands(dtype: torch.dtype, *linears: Linear):
    """Each (w, b) with w cast to the compute dtype (once per call) and laid
    out contiguously, b in fp32."""
    return [
        (w.detach().to(dtype).contiguous(), None if b is None else b.detach().float())
        for w, b in linears
    ]


def _param_dtypes(*linears: Linear):
    return [(w.dtype, None if b is None else b.dtype) for w, b in linears]


def _linear_grads(dtypes, grads):
    """[dw, db, ...] in each parameter's dtype, from `_param_dtypes` and the
    fp32 [(dw, db), ...]; no bias, no bias gradient."""
    out = []
    for (w_dtype, b_dtype), (dw, db) in zip(dtypes, grads):
        out += [dw.to(w_dtype), None if b_dtype is None else db.to(b_dtype)]
    return out


class _AttnHalfTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g1, b1, wqkv, bqkv, wproj, bproj, bias, mask, m1, heads, scale, eps):
        norm1 = (g1.detach(), b1.detach())
        qkv, proj = _compute_operands(x.dtype, (wqkv, bqkv), (wproj, bproj))
        y = swin_attn_half_train_forward(
            x.detach(), norm1, qkv, proj, bias.detach(), mask, m1, heads, scale, eps)
        ctx.save_for_backward(x, g1, b1, qkv[0], proj[0], bias, mask, m1)
        ctx.biases = (qkv[1], proj[1])
        ctx.params = _param_dtypes((wqkv, bqkv), (wproj, bproj))
        ctx.static = (heads, scale, eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g1, b1, wqkv_c, wproj_c, bias, mask, m1 = ctx.saved_tensors
        heads, scale, eps = ctx.static
        dx, dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias = swin_attn_bwd(
            x, dy.contiguous(), (g1, b1), (wqkv_c, ctx.biases[0]), (wproj_c, ctx.biases[1]),
            bias, mask, m1, heads, scale, eps)
        lin = _linear_grads(ctx.params, [(dwqkv, dbqkv), (dwproj, dbproj)])
        return (dx, dg1.to(g1.dtype), dbe1.to(b1.dtype), *lin, dbias.to(bias.dtype),
                None, None, None, None, None)


class _MlpHalfTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, g2, b2, w1, bb1, w2, bb2, m2, eps):
        fc1, fc2 = _compute_operands(x2.dtype, (w1, bb1), (w2, bb2))
        y = swin_mlp_half_train_forward(
            x2.detach(), (g2.detach(), b2.detach()), fc1, fc2, m2, eps)
        ctx.save_for_backward(x2, g2, b2, fc1[0], fc2[0], m2)
        ctx.biases = (fc1[1], fc2[1])
        ctx.params = _param_dtypes((w1, bb1), (w2, bb2))
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, g2, b2, w1_c, w2_c, m2 = ctx.saved_tensors
        dx2, dg2, dbe2, dw1, db1, dw2, db2 = swin_mlp_bwd(
            x2, dy.contiguous(), (g2, b2), (w1_c, ctx.biases[0]), (w2_c, ctx.biases[1]), m2,
            ctx.eps)
        lin = _linear_grads(ctx.params, [(dw1, db1), (dw2, db2)])
        return (dx2, dg2.to(g2.dtype), dbe2.to(b2.dtype), *lin, None, None)


class _BlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2, bias,
                mask, m1, m2, heads, scale, eps):
        qkv, proj, fc1, fc2 = _compute_operands(
            x.dtype, (wqkv, bqkv), (wproj, bproj), (w1, bb1), (w2, bb2))
        y, x2 = swin_block_train_forward(
            x.detach(), (g1.detach(), b1.detach()), qkv, proj, (g2.detach(), b2.detach()),
            fc1, fc2, bias.detach(), mask, m1, m2, heads, scale, eps)
        ctx.save_for_backward(
            x, x2, g1, b1, g2, b2, qkv[0], proj[0], fc1[0], fc2[0], bias, mask, m1, m2)
        ctx.biases = (qkv[1], proj[1], fc1[1], fc2[1])
        ctx.params = _param_dtypes((wqkv, bqkv), (wproj, bproj), (w1, bb1), (w2, bb2))
        ctx.static = (heads, scale, eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        (x, x2, g1, b1, g2, b2, wqkv_c, wproj_c, w1_c, w2_c, bias, mask, m1,
         m2) = ctx.saved_tensors
        bqkv, bproj, bb1, bb2 = ctx.biases
        heads, scale, eps = ctx.static
        # the MLP half's scratch (hidden rows) is released before the
        # attention half allocates its own
        dx2, dg2, dbe2, dw1, db1, dw2, db2 = swin_mlp_bwd(
            x2, dy.contiguous(), (g2, b2), (w1_c, bb1), (w2_c, bb2), m2, eps)
        dx, dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias = swin_attn_bwd(
            x, dx2, (g1, b1), (wqkv_c, bqkv), (wproj_c, bproj), bias, mask, m1, heads, scale,
            eps)
        lin = _linear_grads(
            ctx.params, [(dwqkv, dbqkv), (dwproj, dbproj), (dw1, db1), (dw2, db2)])
        return (dx, dg1.to(g1.dtype), dbe1.to(b1.dtype), *lin[:4], dg2.to(g2.dtype),
                dbe2.to(b2.dtype), *lin[4:], dbias.to(bias.dtype),
                None, None, None, None, None, None)


def swin_block_train(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, norm2: Norm, fc1: Linear,
    fc2: Linear, bias: torch.Tensor, mask: Optional[torch.Tensor], m1: torch.Tensor,
    m2: torch.Tensor, heads: int, scale: float, eps: float,
) -> torch.Tensor:
    """Differentiable whole Swin block for training on window-partitioned x
    (B*nW, N, C) already in the block's layout: x2 = x + m1 * attention
    branch, y = x2 + m2 * MLP branch, m1 and m2 (B,) fp32 per image. Saves x
    and x2; the backward recomputes the internals (B9c, then B9b). Linear
    operands are (w (in, out), b or None) in any float dtype."""
    _check_per_image_scales("swin_block_train", x, m1, m2, mask=mask)
    return _BlockTrain.apply(
        x, *norm1, *qkv, *proj, *norm2, *fc1, *fc2, bias, mask, m1, m2, heads, float(scale),
        float(eps))


def swin_attn_half_train(
    x: torch.Tensor, norm1: Norm, qkv: Linear, proj: Linear, bias: torch.Tensor,
    mask: Optional[torch.Tensor], m1: torch.Tensor, heads: int, scale: float, eps: float,
) -> torch.Tensor:
    """Differentiable x + m1 * proj(window_attention(LN1(x))); saves x, the
    backward is B9b."""
    _check_per_image_scales("swin_attn_half_train", x, m1, mask=mask)
    return _AttnHalfTrain.apply(
        x, *norm1, *qkv, *proj, bias, mask, m1, heads, float(scale), float(eps))


def swin_mlp_half_train(
    x2: torch.Tensor, norm2: Norm, fc1: Linear, fc2: Linear, m2: torch.Tensor, eps: float
) -> torch.Tensor:
    """Differentiable x2 + m2 * fc2(GELU(fc1(LN2(x2)))) over x2 (B*k, ..., C),
    rows image-major; saves x2, the backward is B9c."""
    _check_per_image_scales("swin_mlp_half_train", x2, m2)
    return _MlpHalfTrain.apply(x2, *norm2, *fc1, *fc2, m2, float(eps))


class _WindowTransition(torch.autograd.Function):
    """B11 with its gradient: the inverse of transition (f -> t) is
    transition (t -> f), so the backward is the same kernel with the shifts
    swapped."""

    @staticmethod
    def forward(ctx, x, res, window, from_shift, to_shift):
        ctx.geometry = (res, window, from_shift, to_shift)
        return window_transition(x.detach(), res, window, from_shift, to_shift)

    @staticmethod
    def backward(ctx, g):
        res, window, from_shift, to_shift = ctx.geometry
        return window_transition(g.contiguous(), res, window, to_shift, from_shift), None, \
            None, None, None


def window_transition_train(
    x: torch.Tensor, res: int, window: int, from_shift: int, to_shift: int
) -> torch.Tensor:
    """Differentiable `window_transition` (identity when the shifts agree)."""
    if from_shift == to_shift:
        return x
    return _WindowTransition.apply(x, res, window, from_shift, to_shift)
