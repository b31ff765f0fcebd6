"""Incremental Dynamic-Expansion decode step (kernels K2 and B16,
`csrc/dyn_exp_step.cu`) and their plain versions.

Replaces, from `on_device_image_captioning_tpu/ops/dyn_exp_step.py`:

- `dyn_exp_step_pallas` -> `dyn_exp_step` (K2): one decode position of one
  decoder layer, with the beam reorder fused into the cache reads;
- `dyn_exp_cross_step_pallas` -> `dyn_exp_cross_step` (B16): the same step
  followed, in the same launch, by the residual add, LN2, the single-query
  cross-attention against the image's cached K/V (its Wq and out_linear
  products included) and the second residual add.

The five d x d projections (cond, key, class_a, class_b, selector) stay
`torch.matmul` in the caller (`decode/cache.py`), as they stay in XLA.

The caches are a ping-pong pair: the step reads the source set through
`reorder` and writes every position of the destination set. A kernel may not
write a cache row another row of the same launch still reads, so source and
destination must be different buffers.

Bound and design: see the header of `csrc/dyn_exp_step.cu` (bytes: the
(L, E, d) vals caches; d/64 CTAs per row over column slices).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .layernorm import layernorm_reference

launches = 0  # kernel launches since the last reset (plain-version calls do not count)
cross_launches = 0  # the same for B16 (`dyn_exp_cross_step`)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
COLS_PER_CTA = 64


def dyn_exp_step_reference(
    pos: int,
    reorder: torch.Tensor,
    q_i: torch.Tensor,
    bias_i: torch.Tensor,
    k_i: torch.Tensor,
    ca_i: torch.Tensor,
    cb_i: torch.Tensor,
    cond_i: torch.Tensor,
    sel: torch.Tensor,
    embed: torch.Tensor,
    src: Sequence[torch.Tensor],
    eps: float = 1e-9,
):
    """Plain version. Returns (out (B, d) fp32, new caches (keys, ca, cb, cond,
    vals_a, vals_b)). The math is the XLA branch of the JAX package's
    `decode/cache.py::_dyn_exp_step`, with its products rounded through the
    cache dtype where the Pallas kernel's `_dyn_core` rounds them (a no-op in
    fp32).

    q_i, bias_i: (B, E, d); k_i, ca_i, cb_i, cond_i: (B, d); sel: (B, d) fp32;
    embed: (E, d); src caches keys/ca/cb/cond (Bs, L, d), vals (Bs, L, E, d),
    all in the cache dtype; reorder: (B,) source rows of the B output rows."""
    keys, ca, cb, cond, vals_a, vals_b = (t.index_select(0, reorder.long()) for t in src)
    b, L, E, d = vals_a.shape
    cd = keys.dtype
    f32 = torch.float32
    keys[:, pos] = k_i
    ca[:, pos] = ca_i
    cb[:, pos] = cb_i
    cond[:, pos] = cond_i
    sqrt_d = float(d) ** 0.5
    valid = torch.arange(L, device=keys.device) <= pos  # (L,)

    def rnd(x):  # round through the cache dtype
        return x.to(cd).to(f32)

    z_fw = torch.einsum("bed,bld->bel", q_i.to(f32), keys.to(f32)) / sqrt_d
    a_fw = torch.where(valid, torch.relu(z_fw), 0.0)
    b_fw = torch.where(valid, torch.relu(-z_fw), 0.0)
    a_fw = a_fw / (a_fw.sum(-1, keepdim=True) + eps)
    b_fw = b_fw / (b_fw.sum(-1, keepdim=True) + eps)
    fw_a = torch.einsum("bel,bld->bed", rnd(a_fw), ca.to(f32))
    fw_b = torch.einsum("bel,bld->bed", rnd(b_fw), cb.to(f32))
    vals_a[:, pos] = (fw_a + bias_i.to(f32)).to(cd)
    vals_b[:, pos] = (fw_b + bias_i.to(f32)).to(cd)

    kq = k_i.to(f32)
    ze = torch.einsum("ed,bd->be", embed.to(f32), kq)  # (B, E)
    zc = torch.einsum("bld,bd->bl", cond.to(f32), kq)  # (B, L)
    z_col = (zc[:, :, None] + ze[:, None, :]) / sqrt_d  # (B, L, E)
    a_bw = torch.where(valid[:, None], torch.relu(z_col), 0.0).reshape(b, L * E)
    b_bw = torch.where(valid[:, None], torch.relu(-z_col), 0.0).reshape(b, L * E)
    a_bw = a_bw / (a_bw.sum(-1, keepdim=True) + eps)
    b_bw = b_bw / (b_bw.sum(-1, keepdim=True) + eps)
    out_a = torch.einsum("bq,bqd->bd", rnd(a_bw), vals_a.reshape(b, L * E, d).to(f32))
    out_b = torch.einsum("bq,bqd->bd", rnd(b_bw), vals_b.reshape(b, L * E, d).to(f32))
    sel = sel.to(f32)
    out = sel * out_a + (1.0 - sel) * out_b
    return out, (keys, ca, cb, cond, vals_a, vals_b)


def cross_tail_reference(
    out, y, ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, *,
    heads: int, ln_eps: float, attn_fill: float, group: int = 1, compute_dtype=None,
) -> torch.Tensor:
    """y + out -> LN2 -> single-query cross-attention -> + residual, with the
    TPU kernel's rounding points (`_cross_tail`): `rd` (the compute dtype)
    after each linear and on each linear's input, `cd` (the cache dtype) for
    q and the attention weights, fp32 statistics, softmax and sums."""
    rd = compute_dtype if compute_dtype is not None else torch.float32
    cd = k_cross.dtype
    f32 = torch.float32
    y1 = y.to(f32) + out
    b, d = y1.shape
    bi, s = b // group, k_cross.shape[1]
    dk = d // heads
    x2 = layernorm_reference(y1, ln2[0], ln2[1], ln_eps)
    q = torch.matmul(x2.to(rd).to(f32), wq.to(rd).to(f32)) + bq.to(f32)
    q = q.to(rd).to(cd).to(f32).reshape(bi, group, heads, dk)
    k = k_cross.to(f32).reshape(bi, s, heads, dk)
    v = v_cross.to(f32).reshape(bi, s, heads, dk)
    scores = torch.einsum("bghd,bshd->bghs", q, k) / (dk**0.5)
    if enc_mask is not None:
        scores = torch.where(enc_mask[:, None, None, :] > 0, scores, attn_fill)
    attn = torch.softmax(scores, dim=-1).to(cd).to(f32)
    o = torch.einsum("bghs,bshd->bghd", attn, v).reshape(b, d).to(rd).to(f32)
    mo = (torch.matmul(o, wo.to(rd).to(f32)) + bo.to(f32)).to(rd).to(f32)
    return y1 + mo


def dyn_exp_cross_step_reference(
    pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
    y, ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, src, *,
    heads: int, ln_eps: float, attn_fill: float, group: int = 1, eps: float = 1e-9,
    compute_dtype=None,
):
    """Plain version of B16. Returns (y_out (B, d) fp32, new caches)."""
    out, new = dyn_exp_step_reference(
        pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, eps)
    y_out = cross_tail_reference(
        out, y, ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, heads=heads,
        ln_eps=ln_eps, attn_fill=attn_fill, group=group, compute_dtype=compute_dtype)
    return y_out, new


_STEP_ARGTYPES = [ctypes.c_void_p] * 22 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_CROSS_ARGTYPES = (
    [ctypes.c_void_p] * 34 + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
    + [ctypes.c_int, ctypes.c_void_p]
)


def _check_step_operands(name, pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel,
                         embed, src, dst) -> Tuple[int, int, int, int]:
    """What K2 and B16 ask of the step's operands. Returns (B, L, E, d)."""
    vals_src = src[4]
    bs, L, E, d = vals_src.shape
    b = k_i.shape[0]
    cd = vals_src.dtype
    if cd not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported cache dtype {cd}")
    if d % COLS_PER_CTA or not 0 <= pos < L:
        raise ValueError(f"{name}: unsupported d={d} / pos={pos} / L={L}")
    shapes = [(b, E, d), (b, E, d), (b, d), (b, d), (b, d), (b, d)]
    for t, shape in zip((q_i, bias_i, k_i, ca_i, cb_i, cond_i), shapes):
        if t.shape != shape or t.dtype != cd:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype}, want {shape} {cd}")
    if embed.shape != (E, d) or embed.dtype != cd:
        raise ValueError(f"{name}: embed must be (E, d) in the cache dtype")
    if sel.shape != (b, d) or sel.dtype != torch.float32:
        raise ValueError(f"{name}: sel must be (B, d) fp32")
    if reorder.shape != (b,) or reorder.dtype != torch.int32:
        raise ValueError(f"{name}: reorder must be (B,) int32")
    want_src = [(bs, L, d)] * 4 + [(bs, L, E, d)] * 2
    want_dst = [(b, L, d)] * 4 + [(b, L, E, d)] * 2
    for s_, d_, ws, wd in zip(src, dst, want_src, want_dst):
        if s_.shape != ws or d_.shape != wd or s_.dtype != cd or d_.dtype != cd:
            raise ValueError(f"{name}: cache shapes or dtypes disagree")
    src_ptrs = {t.data_ptr() for t in src}
    if any(t.data_ptr() in src_ptrs for t in dst):
        raise ValueError(f"{name}: dst caches alias the src caches")
    return b, L, E, d


def dyn_exp_step(
    pos: int,
    reorder: torch.Tensor,
    q_i: torch.Tensor,
    bias_i: torch.Tensor,
    k_i: torch.Tensor,
    ca_i: torch.Tensor,
    cb_i: torch.Tensor,
    cond_i: torch.Tensor,
    sel: torch.Tensor,
    embed: torch.Tensor,
    src: Sequence[torch.Tensor],
    dst: Sequence[torch.Tensor],
    eps: float = 1e-9,
) -> torch.Tensor:
    """One decode step: writes all six dst caches and returns out (B, d) fp32.
    CPU tensors get the plain version; CUDA tensors get kernel K2."""
    global launches
    if k_i.device.type == "cpu":
        out, new = dyn_exp_step_reference(
            pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, eps
        )
        for d_, n_ in zip(dst, new):
            d_.copy_(n_)
        return out
    if k_i.device.type != "cuda":
        raise ValueError(f"dyn_exp_step: unsupported device {k_i.device}")

    b, L, E, d = _check_step_operands(
        "dyn_exp_step", pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
        src, dst)
    cd = src[4].dtype
    _build.check_cuda_tensors(
        reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, *src, *dst
    )
    out = torch.empty((b, d), dtype=torch.float32, device=k_i.device)
    fn = _build.cuda_function("dyn_exp_step", "dyn_exp_step_launch", _STEP_ARGTYPES)
    status = fn(
        reorder.data_ptr(), q_i.data_ptr(), bias_i.data_ptr(), k_i.data_ptr(),
        ca_i.data_ptr(), cb_i.data_ptr(), cond_i.data_ptr(), sel.data_ptr(),
        embed.data_ptr(), *(t.data_ptr() for t in src),
        *(t.data_ptr() for t in dst), out.data_ptr(),
        b, L, E, d, int(pos), float(d) ** 0.5, float(eps), _DTYPE_CODE[cd],
        _build.current_stream(),
    )
    _build.check_status(status, "dyn_exp_step")
    launches += 1
    return out


_counters: dict = {}  # device -> (rows,) int32 zeros; B16's kernel leaves them zero


def _row_counters(device: torch.device, rows: int) -> torch.Tensor:
    have = _counters.get(device)
    if have is None or have.shape[0] < rows:
        have = torch.zeros((max(rows, 64),), dtype=torch.int32, device=device)
        _counters[device] = have
    return have


def dyn_exp_cross_step(
    pos: int,
    reorder: torch.Tensor,
    q_i: torch.Tensor,
    bias_i: torch.Tensor,
    k_i: torch.Tensor,
    ca_i: torch.Tensor,
    cb_i: torch.Tensor,
    cond_i: torch.Tensor,
    sel: torch.Tensor,
    embed: torch.Tensor,
    y: torch.Tensor,
    ln2: Tuple[torch.Tensor, torch.Tensor],
    wq: torch.Tensor,
    bq: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    k_cross: torch.Tensor,
    v_cross: torch.Tensor,
    enc_mask: Optional[torch.Tensor],
    src: Sequence[torch.Tensor],
    dst: Sequence[torch.Tensor],
    *,
    heads: int,
    ln_eps: float,
    attn_fill: float,
    group: int = 1,
    eps: float = 1e-9,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One decode step of a decoder layer up to and including its
    cross-attention: writes all six dst caches and returns the residual stream
    y + dyn + cross (B, d) fp32.

    y (B, d) fp32 is the stream before the dynamic-expansion add; ln2 =
    (scale, bias) fp32; wq, wo (d, d) as (in, out) in the compute dtype, bq,
    bo fp32; k_cross, v_cross (B / group, S, d) in the cache dtype; enc_mask
    (B / group, S) fp32, > 0 where the encoder token is real, or None. Row i
    reads image row i // group. CPU tensors get the plain version; CUDA
    tensors get kernel B16, which is built for compute dtype == cache dtype."""
    global cross_launches
    tail = dict(heads=heads, ln_eps=ln_eps, attn_fill=attn_fill, group=group,
                compute_dtype=compute_dtype)
    if k_i.device.type == "cpu":
        y_out, new = dyn_exp_cross_step_reference(
            pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
            y, ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, src, eps=eps, **tail)
        for d_, n_ in zip(dst, new):
            d_.copy_(n_)
        return y_out
    if k_i.device.type != "cuda":
        raise ValueError(f"dyn_exp_cross_step: unsupported device {k_i.device}")

    name = "dyn_exp_cross_step"
    b, L, E, d = _check_step_operands(
        name, pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, dst)
    cd = src[4].dtype
    rd = compute_dtype if compute_dtype is not None else torch.float32
    if rd != cd:
        raise ValueError(f"{name}: B16 takes compute dtype == cache dtype, got {rd} / {cd}")
    chunk = 16 // k_cross.element_size()  # output columns a thread takes
    if d % heads or (d // heads) % chunk or (d // chunk) > 256 or 256 % (d // chunk):
        raise ValueError(f"{name}: unsupported d={d} / heads={heads}")
    if group < 1 or b % group:
        raise ValueError(f"{name}: {b} rows do not split into groups of {group}")
    s_enc = k_cross.shape[1]
    if k_cross.shape != (b // group, s_enc, d) or v_cross.shape != k_cross.shape or (
            k_cross.dtype != cd or v_cross.dtype != cd):
        raise ValueError(f"{name}: k_cross, v_cross must be (B / group, S, d) in the cache dtype")
    for w_ in (wq, wo):
        if w_.shape != (d, d) or w_.dtype != cd:
            raise ValueError(f"{name}: wq, wo must be (d, d) as (in, out) in the cache dtype")
    for v_ in (y, *ln2, bq, bo):
        if v_.dtype != torch.float32 or v_.shape[-1] != d:
            raise ValueError(f"{name}: y, ln2, bq, bo must be fp32 of width d")
    if y.shape != (b, d):
        raise ValueError(f"{name}: y must be (B, d)")
    if enc_mask is not None and (
            enc_mask.dtype != torch.float32 or enc_mask.shape != (b // group, s_enc)):
        raise ValueError(f"{name}: enc_mask must be fp32 (B / group, S)")
    operands = [reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, *src, *dst,
                y, *ln2, wq, bq, wo, bo, k_cross, v_cross]
    if enc_mask is not None:
        operands.append(enc_mask)
    _build.check_cuda_tensors(*operands)
    out = torch.empty((b, d), dtype=torch.float32, device=k_i.device)
    y_out = torch.empty_like(out)
    counter = _row_counters(k_i.device, b)
    fn = _build.cuda_function("dyn_exp_step", "dyn_exp_cross_step_launch", _CROSS_ARGTYPES)
    status = fn(
        reorder.data_ptr(), q_i.data_ptr(), bias_i.data_ptr(), k_i.data_ptr(),
        ca_i.data_ptr(), cb_i.data_ptr(), cond_i.data_ptr(), sel.data_ptr(),
        embed.data_ptr(), *(t.data_ptr() for t in src),
        *(t.data_ptr() for t in dst), out.data_ptr(), y.data_ptr(),
        ln2[0].data_ptr(), ln2[1].data_ptr(), wq.data_ptr(), bq.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), k_cross.data_ptr(), v_cross.data_ptr(),
        None if enc_mask is None else enc_mask.data_ptr(), y_out.data_ptr(),
        counter.data_ptr(), b, L, E, d, int(pos), s_enc, heads, group,
        float(d) ** 0.5, float(eps), float(ln_eps), float(attn_fill), _DTYPE_CODE[cd],
        _build.current_stream(),
    )
    _build.check_status(status, name)
    cross_launches += 1
    return y_out
