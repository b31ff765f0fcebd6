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
  `csrc/window_transition.cu`): the permuting copy between two shift layouts.

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
from .layernorm import layernorm_reference
from .window_attention import HEAD_DIM
from .window_layout import window_transition_perm

# wrapper calls that launched their kernels since the last reset (plain-version
# calls do not count); one call of B6 is one launch, of B4 a chain of three,
# of B5 two
block_launches = 0
attn_half_launches = 0
mlp_half_launches = 0
transition_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
Norm = Tuple[torch.Tensor, torch.Tensor]  # (scale, bias), fp32
Linear = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (w (in, out) in x.dtype, b fp32 or None)
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
