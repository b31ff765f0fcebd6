"""Incremental decoder state for autoregressive decoding (counterpart of the
JAX package's `decode/cache.py`).

One token per step with exact numerics: the Dynamic Expansion block admits an
exact incremental form because all of its normalizations are row-local (see
the JAX module docstring). Per decoder layer the state caches key / class_a /
class_b / cond rows (B, L, d) and the finalized vals_a / vals_b rows
(B, L, E, d); the cross-attention K/V over the encoder tokens are projected
once, one row per image, and shared by the image's beams or samples
(`group`); so is the encoder pad mask of padded feature batches.

`dec_step(..., step_impl=...)` chooses between the two decode-step paths the
JAX package names in `set_dyn_step_impl`: "pallas" is kernel K2 followed by
LN2 and the cross-attention as separate calls, "pallas_fused" is kernel B16,
which runs all of that in one launch per layer.

The per-position caches are a ping-pong pair: step t reads the current set
through `reorder` (the beam reshuffle, fused into kernel K2's cache reads)
and writes every position of the spare set, which then becomes current. A
kernel may not write a cache row that another row of the same launch still
reads, so the two sets are always distinct buffers. A step allocates the
spare set anew wherever its rows or its length differ from the current
set's: a state grown between the phases of a chunked decode (`grow_state`)
never hands the kernels a destination of the old length.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from ..config import CaptionerConfig
from ..deploy.quantization import QuantLinear
from ..models.captioner import ExpansionNetV2
from ..models.common import embedding, layernorm, linear
from ..ops.dyn_exp_step import dyn_exp_cross_step, dyn_exp_step

STEP_IMPLS = ("pallas", "pallas_fused")

# keys, ca, cb, cond (B, L, d) and vals_a, vals_b (B, L, E, d) of one layer
LayerCaches = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class DecState:
    caches: List[LayerCaches]  # current set, one per decoder layer
    spare: Optional[List[LayerCaches]]  # the other set (written next step), or None
    cross: List[Tuple[torch.Tensor, torch.Tensor]]  # (k_cross, v_cross) (B_img, S, d)
    # (B_img, S) fp32, 1 where the encoder token is real and 0 on trailing pad
    # rows (padded feature batches); None = no encoder pads
    enc_mask: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.caches[0][0].shape[0]

    @property
    def length(self) -> int:
        return self.caches[0][0].shape[1]


def _alloc_caches(cfg: CaptionerConfig, rows: int, max_len: int, dtype, device, fill_zero):
    d, e = cfg.d_model, cfg.num_exp_dec
    new = torch.zeros if fill_zero else torch.empty
    small = [new((rows, max_len, d), dtype=dtype, device=device) for _ in range(4)]
    vals = [new((rows, max_len, e, d), dtype=dtype, device=device) for _ in range(2)]
    return tuple(small + vals)


def init_state(
    model: ExpansionNetV2,
    cfg: CaptionerConfig,
    enc_output: torch.Tensor,
    max_len: int,
    cache_dtype: torch.dtype = torch.float32,
    enc_num_pads: Optional[torch.Tensor] = None,
) -> DecState:
    """Zeroed caches (one row per image) and the cross-attention K/V of every
    layer, projected once in fp32 and stored in the cache dtype (a quantized
    projection takes the encoder output in its own dtype, as the JAX
    package's `linear` hands it to its int8 product). enc_num_pads
    (B,) counts the trailing pad rows of each enc_output row; it becomes the
    cross-attention mask the state carries."""
    b, s = enc_output.shape[:2]
    dev = enc_output.device
    enc_mask = None
    if enc_num_pads is not None:
        real = s - enc_num_pads.to(dev).long().reshape(b, 1)
        enc_mask = (torch.arange(s, device=dev)[None, :] < real).float()
    caches = [
        _alloc_caches(cfg, b, max_len, cache_dtype, dev, fill_zero=True)
        for _ in range(cfg.N_dec)
    ]
    def project(proj):
        x = enc_output if isinstance(proj, QuantLinear) else enc_output.float()
        return linear(proj, x).to(cache_dtype)

    cross = [(project(layer.mha.Wk), project(layer.mha.Wv)) for layer in model.decoders]
    return DecState(caches=caches, spare=None, cross=cross, enc_mask=enc_mask)


def grow_state(state: DecState, new_len: int) -> DecState:
    """The state with every per-position cache zero-padded on its position
    axis (axis 1) to `new_len` (a state already that long is returned as it
    is): the step between two phases of a chunked decode. Decode masks the
    positions after `pos`, so the zeros are never read as data. The spare set
    is dropped (the next step allocates one of the new length); the cross K/V
    and the encoder mask, which have no position axis, are kept."""
    if state.length >= new_len:
        return state

    def pad(t):
        return torch.cat([t, t.new_zeros((t.shape[0], new_len - t.shape[1], *t.shape[2:]))], 1)

    return DecState(caches=[tuple(pad(t) for t in layer) for layer in state.caches],
                    spare=None, cross=state.cross, enc_mask=state.enc_mask)


def _step_operands(p, x2: torch.Tensor, cd: torch.dtype, dtype=None):
    """The five projections of x2 (B, d) and what the step kernels read of
    them, in the cache dtype: (q_i, bias_i, k_i, ca_i, cb_i, cond, sel, embed)."""
    cond = linear(p.cond_embed, x2, dtype)
    k_i = linear(p.key_linear, x2, dtype)
    ca_i = linear(p.class_a_embed, x2, dtype)
    cb_i = linear(p.class_b_embed, x2, dtype)
    sel = torch.sigmoid(linear(p.selector_embed, x2, dtype).float())
    embed = p.query_exp_vectors.weight
    q_i = embed[None] + cond[:, None]  # (B, E, d)
    bias_i = p.bias_exp_vectors.weight[None] + cond[:, None]
    return (q_i.to(cd), bias_i.to(cd), k_i.to(cd), ca_i.to(cd), cb_i.to(cd), cond.to(cd),
            sel, embed.to(cd))


def _dyn_exp_step(
    p, cfg: CaptionerConfig, src: LayerCaches, dst: LayerCaches, x2: torch.Tensor,
    pos: int, reorder: torch.Tensor, dtype=None,
) -> torch.Tensor:
    """One-position Dynamic Expansion: x2 (B, d) normalized input at `pos`.
    Reads src through reorder, writes all of dst, returns (B, d) fp32."""
    return dyn_exp_step(
        pos, reorder, *_step_operands(p, x2, src[0].dtype, dtype), src, dst, eps=cfg.eps)


def tensor_state(t: torch.Tensor) -> Tuple[int, int]:
    """(storage address, version counter) of a parameter: what changes when
    it is replaced or updated in place (an inference tensor keeps no version
    counter and cannot change in place: version 0)."""
    return t.data_ptr(), 0 if t.is_inference() else t._version


def _cross_operands(layer, dtype):
    """(ln2, wq, bq, wo, bo) of the fused step: LN2's parameters, and Wq and
    out_linear as (in, out) matrices in the compute dtype with fp32 biases.
    Laid out once per layer, dtype and state of the parameters (their storage
    and version counters, so that new or moved weights are laid out anew), and
    kept on the layer; under `torch.export` laid out in the graph instead."""
    rd = dtype if dtype is not None else torch.float32
    mha = layer.mha

    def lay_out():
        return (
            (layer.norm_2.weight.detach().float(), layer.norm_2.bias.detach().float()),
            mha.Wq.weight.detach().to(rd).t().contiguous(), mha.Wq.bias.detach().float(),
            mha.out_linear.weight.detach().to(rd).t().contiguous(),
            mha.out_linear.bias.detach().float(),
        )

    if torch.compiler.is_compiling():  # traced (`deploy/aot.py`): laid out in the graph
        return lay_out()
    params = (layer.norm_2.weight, layer.norm_2.bias, mha.Wq.weight, mha.Wq.bias,
              mha.out_linear.weight, mha.out_linear.bias)
    key = (rd, *map(tensor_state, params))
    cached = getattr(layer, "_cross_operands", None)
    if cached is None or cached[0] != key:
        cached = (key, lay_out())
        layer._cross_operands = cached
    return cached[1]


def _dyn_cross_fused_step(
    layer, cfg: CaptionerConfig, src: LayerCaches, dst: LayerCaches, y: torch.Tensor,
    kc: torch.Tensor, vc: torch.Tensor, enc_mask: Optional[torch.Tensor], pos: int,
    reorder: torch.Tensor, dtype=None, group: int = 1,
) -> torch.Tensor:
    """One decoder layer's dynamic expansion + LN2 + cross-attention with both
    residual adds as one call of kernel B16; LN1 and the five projections stay
    outside. Returns the stream after the cross-attention add, (B, d) fp32."""
    x2 = layernorm(layer.norm_1, y, cfg.ln_eps)
    ln2, wq, bq, wo, bo = _cross_operands(layer, dtype)
    return dyn_exp_cross_step(
        pos, reorder, *_step_operands(layer.dyn_exp, x2, src[0].dtype, dtype),
        y, ln2, wq, bq, wo, bo, kc, vc, enc_mask, src, dst,
        heads=cfg.num_heads, ln_eps=cfg.ln_eps, attn_fill=cfg.attn_fill, group=group,
        eps=cfg.eps, compute_dtype=dtype,
    )


def _cross_attention_step(
    mha, cfg: CaptionerConfig, k_cross: torch.Tensor, v_cross: torch.Tensor,
    x2: torch.Tensor, dtype=None, group: int = 1,
    enc_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-query cross-attention against the cached encoder K/V. x2 has
    B_img * group rows; each group of consecutive rows (the beams or samples
    of one image) shares one K/V row and one row of enc_mask, which masks
    padded feature rows with the fill of the full forward's attention."""
    rows, d = x2.shape
    h, dk = cfg.num_heads, cfg.head_dim
    b = rows // group
    s = k_cross.shape[1]
    k = k_cross.reshape(b, s, h, dk)
    v = v_cross.reshape(b, s, h, dk)
    q = linear(mha.Wq, x2, dtype).reshape(b, group, h, dk).to(k.dtype)
    scores = torch.einsum("bghd,bshd->bghs", q.float(), k.float()) / (dk**0.5)
    if enc_mask is not None:
        scores = torch.where(enc_mask[:, None, None, :] > 0, scores, cfg.attn_fill)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bghs,bshd->bghd", attn.to(v.dtype).float(), v.float())
    return linear(mha.out_linear, out.reshape(rows, d), dtype)


def dec_step_unguarded(
    model: ExpansionNetV2,
    cfg: CaptionerConfig,
    state: DecState,
    tokens: torch.Tensor,
    pos: int,
    dtype: Optional[torch.dtype] = None,
    reorder: Optional[torch.Tensor] = None,
    group: int = 1,
    step_impl: str = "pallas",
) -> Tuple[torch.Tensor, DecState]:
    """Decode position `pos` for every row. tokens (R,) ids; reorder (R,)
    int32: output row i continues current cache row reorder[i] (identity when
    None; R may differ from the current row count, which is how the SOS
    state expands to beams). group: rows per image (beams or samples); the
    cross K/V and the pad mask keep one row per image. step_impl: "pallas"
    (the step kernel, then LN2 and the cross-attention as separate calls) or
    "pallas_fused" (all of it in one kernel call per layer; a layer whose Wq
    is quantized takes the "pallas" step, as in the JAX package). Returns
    (log_probs (R, vocab) fp32, new state). Matches
    forward_dec(..., apply_log_softmax=True)[:, pos]. Runs under the
    caller's grad mode (`dec_step` turns gradients off; a traced caller,
    `deploy/aot.py`, exports under no_grad, and a grad-mode switch inside
    the trace would split its graph)."""
    if step_impl not in STEP_IMPLS:
        raise ValueError(f"step_impl {step_impl!r}; expected one of {STEP_IMPLS}")
    rows = tokens.shape[0]
    dev = tokens.device
    if reorder is None:
        reorder = torch.arange(rows, dtype=torch.int32, device=dev)
    spare = state.spare
    if spare is None or spare[0][0].shape[:2] != (rows, state.length):
        cd = state.caches[0][0].dtype
        spare = [
            _alloc_caches(cfg, rows, state.length, cd, dev, fill_zero=False)
            for _ in range(cfg.N_dec)
        ]

    y = embedding(model.out_embedder.embed, tokens) * math.sqrt(float(cfg.d_model))
    y = y + model.pos_encoder.weight[pos][None]
    y_list = []
    for layer, src, dst, (kc, vc) in zip(model.decoders, state.caches, spare, state.cross):
        if step_impl == "pallas_fused" and not isinstance(layer.mha.Wq, QuantLinear):
            y = _dyn_cross_fused_step(
                layer, cfg, src, dst, y, kc, vc, state.enc_mask, pos, reorder, dtype, group)
        else:
            x2 = layernorm(layer.norm_1, y, cfg.ln_eps)
            y = y + _dyn_exp_step(layer.dyn_exp, cfg, src, dst, x2, pos, reorder, dtype)
            x2 = layernorm(layer.norm_2, y, cfg.ln_eps)
            y = y + _cross_attention_step(
                layer.mha, cfg, kc, vc, x2, dtype, group, state.enc_mask)
        x2 = layernorm(layer.norm_3, y, cfg.ln_eps)
        y = y + layer.ff(x2, dtype)
        y_list.append(y)
    y = y + linear(model.dec_reduce_group, torch.cat(y_list, dim=-1), dtype)
    y = layernorm(model.dec_reduce_norm, y, cfg.ln_eps)
    logits = linear(model.vocab_linear, y, dtype)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    same_rows = state.rows == rows
    new_state = DecState(
        caches=spare, spare=state.caches if same_rows else None, cross=state.cross,
        enc_mask=state.enc_mask,
    )
    return log_probs, new_state


@torch.no_grad()
def dec_step(
    model: ExpansionNetV2,
    cfg: CaptionerConfig,
    state: DecState,
    tokens: torch.Tensor,
    pos: int,
    dtype: Optional[torch.dtype] = None,
    reorder: Optional[torch.Tensor] = None,
    group: int = 1,
    step_impl: str = "pallas",
) -> Tuple[torch.Tensor, DecState]:
    """`dec_step_unguarded` (see there) with gradients off."""
    return dec_step_unguarded(model, cfg, state, tokens, pos, dtype, reorder, group, step_impl)
