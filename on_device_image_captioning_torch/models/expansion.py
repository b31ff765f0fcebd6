"""Block Static / Dynamic Expansion, multi-head attention, feed-forward and the
encoder / decoder layers of ExpansionNet v2 (inference and training).

Counterpart of the JAX package's `models/expansion.py`; parameter names are
the reference repo's (models/layers.py), so a reference state_dict loads
unchanged. Semantics kept exactly:

- expansion score z = Q . key(x)^T / sqrt(d_model); ReLU(z) / ReLU(-z) dual
  paths; forward L1-normalized over keys (+eps), backward L1-normalized per
  expansion group (static block) or over the full row (dynamic block);
- the static block's backward path is not masked;
- attention scores are masked with a -1e4 fill before the softmax, written
  as matmul -> masked fill -> softmax -> matmul so the fill matches exactly;
- eps = 1e-9 on every normalization denominator;
- the dropouts sit where the JAX package's `static_expansion`,
  `dynamic_expansion`, `feed_forward` and the layers have them (on z, on the
  class sums before and after the backward path, after the FF's ReLU, on each
  sublayer's output), at `cfg.drop.enc` / `cfg.drop.dec`, and are off unless
  `train` is set and a `torch.Generator` is given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import CaptionerConfig
from ..ops.masks import expand_mask_cols, expand_mask_rows
from .common import column_cut, dropout, f32_einsum, layernorm, linear


def _l1_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (x.sum(dim=-1, keepdim=True) + eps)


def _group_l1_normalize(x: torch.Tensor, groups: Sequence[int], eps: float) -> torch.Tensor:
    """L1-normalize slices of the last axis independently per expansion group."""
    return torch.cat(
        [_l1_normalize(part, eps) for part in torch.split(x, list(groups), dim=-1)],
        dim=-1,
    )


class StaticExpansionBlock(nn.Module):
    """Block Static Expansion (reference models/layers.py:45-102)."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        d, s = cfg.d_model, cfg.sum_exp_enc
        self.query_exp_vectors = nn.Embedding(s, d)
        self.bias_exp_vectors = nn.Embedding(s, d)
        self.key_embed = nn.Linear(d, d)
        self.class_a_embed = nn.Linear(d, d)
        self.class_b_embed = nn.Linear(d, d)
        self.selector_embed = nn.Linear(d, d)

    def forward(self, x, mask: Optional[torch.Tensor], dtype=None, train: bool = False,
                generator=None) -> torch.Tensor:
        """x (B, S, d); mask bool (B, sum_exp, S) or None. Returns fp32."""
        cfg = self.cfg
        drop = lambda t: dropout(t, cfg.drop.enc, train, generator)  # noqa: E731
        q = self.query_exp_vectors.weight  # (sum_exp, d), full table in index order
        bias = self.bias_exp_vectors.weight
        x_key = linear(self.key_embed, x, dtype)
        z = drop(f32_einsum("ed,bsd->bes", q.to(x_key.dtype), x_key) / (cfg.d_model**0.5))

        a_fw = torch.relu(z)
        b_fw = torch.relu(-z)
        if mask is not None:
            a_fw = torch.where(mask, a_fw, 0.0)
            b_fw = torch.where(mask, b_fw, 0.0)
        a_fw = _l1_normalize(a_fw, cfg.eps)
        b_fw = _l1_normalize(b_fw, cfg.eps)
        class_a = drop(
            f32_einsum("bes,bsd->bed", a_fw, linear(self.class_a_embed, x, dtype)) + bias)
        class_b = drop(
            f32_einsum("bes,bsd->bed", b_fw, linear(self.class_b_embed, x, dtype)) + bias)

        zt = z.transpose(-1, -2)  # backward path: group-normalized, not masked
        a_bw = _group_l1_normalize(torch.relu(zt), cfg.num_exp_enc_list, cfg.eps)
        b_bw = _group_l1_normalize(torch.relu(-zt), cfg.num_exp_enc_list, cfg.eps)
        n_groups = float(len(cfg.num_exp_enc_list))
        class_a = drop(torch.matmul(a_bw, class_a) / n_groups)
        class_b = drop(torch.matmul(b_bw, class_b) / n_groups)

        selector = torch.sigmoid(linear(self.selector_embed, x, dtype).float())
        return selector * class_a + (1.0 - selector) * class_b


class DynamicExpansionBlock(nn.Module):
    """Block Dynamic Expansion over a full token prefix (reference
    models/layers.py:152-204). Incremental decoding uses decode/cache.py."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.d_model, cfg.num_exp_dec
        self.cond_embed = nn.Linear(d, d)
        self.query_exp_vectors = nn.Embedding(e, d)
        self.bias_exp_vectors = nn.Embedding(e, d)
        self.key_linear = nn.Linear(d, d)
        self.class_a_embed = nn.Linear(d, d)
        self.class_b_embed = nn.Linear(d, d)
        self.selector_embed = nn.Linear(d, d)

    def forward(self, x, mask: torch.Tensor, dtype=None, train: bool = False,
                generator=None) -> torch.Tensor:
        """x (B, T, d); mask bool (B, T, T) causal(+pad). Returns fp32."""
        cfg = self.cfg
        drop = lambda t_: dropout(t_, cfg.drop.dec, train, generator)  # noqa: E731
        b, t, d = x.shape
        e = cfg.num_exp_dec
        cond = linear(self.cond_embed, x, dtype).reshape(b, t, 1, d)
        q = (self.query_exp_vectors.weight[None, None] + cond).reshape(b, t * e, d)
        bias = (self.bias_exp_vectors.weight[None, None] + cond).reshape(b, t * e, d)
        x_key = linear(self.key_linear, x, dtype)
        z = drop(f32_einsum("bqd,btd->bqt", q.to(x_key.dtype), x_key) / (d**0.5))

        mask_rows = expand_mask_rows(mask, e)
        a_fw = _l1_normalize(torch.where(mask_rows, torch.relu(z), 0.0), cfg.eps)
        b_fw = _l1_normalize(torch.where(mask_rows, torch.relu(-z), 0.0), cfg.eps)
        class_a = drop(f32_einsum("bqt,btd->bqd", a_fw, linear(self.class_a_embed, x, dtype)))
        class_b = drop(f32_einsum("bqt,btd->bqd", b_fw, linear(self.class_b_embed, x, dtype)))

        mask_cols = expand_mask_cols(mask, e)
        zt = z.transpose(-1, -2)  # (B, T, T*e)
        a_bw = _l1_normalize(torch.where(mask_cols, torch.relu(zt), 0.0), cfg.eps)
        b_bw = _l1_normalize(torch.where(mask_cols, torch.relu(-zt), 0.0), cfg.eps)
        class_a = drop(torch.matmul(a_bw, class_a + bias.float()))
        class_b = drop(torch.matmul(b_bw, class_b + bias.float()))

        selector = torch.sigmoid(linear(self.selector_embed, x, dtype).float())
        return selector * class_a + (1.0 - selector) * class_b


class MultiHeadAttention(nn.Module):
    """MHA with -1e4 additive masking (reference models/layers.py:266-295)."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.Wq = nn.Linear(d, d)
        self.Wk = nn.Linear(d, d)
        self.Wv = nn.Linear(d, d)
        self.out_linear = nn.Linear(d, d)

    def forward(self, q, k, v, mask: Optional[torch.Tensor], dtype=None) -> torch.Tensor:
        cfg = self.cfg
        b, tq, d = q.shape
        h, dk = cfg.num_heads, cfg.head_dim
        qp = linear(self.Wq, q, dtype).reshape(b, tq, h, dk)
        kp = linear(self.Wk, k, dtype).reshape(b, k.shape[1], h, dk)
        vp = linear(self.Wv, v, dtype).reshape(b, v.shape[1], h, dk)
        scores = f32_einsum("bqhd,bkhd->bhqk", qp, kp) / (dk**0.5)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None], cfg.attn_fill)
        attn = torch.softmax(scores, dim=-1)
        out = f32_einsum("bhqk,bkhd->bqhd", attn.to(vp.dtype), vp)
        out = out.to(vp.dtype).reshape(b, tq, d)
        return linear(self.out_linear, out, dtype)


class FeedForward(nn.Module):
    """linear -> relu -> dropout -> linear (reference models/layers.py:298-308)."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.linear_1 = nn.Linear(cfg.d_model, cfg.ff)
        self.linear_2 = nn.Linear(cfg.ff, cfg.d_model)

    def forward(self, x, dtype=None, rate: float = 0.0, train: bool = False,
                generator=None) -> torch.Tensor:
        h = dropout(torch.relu(linear(self.linear_1, x, dtype)), rate, train, generator,
                    column_cut(self.linear_1))
        return linear(self.linear_2, h, dtype)


class EncoderLayer(nn.Module):
    """Pre-LN encoder layer (reference models/layers.py:118-123)."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        self.norm_1 = nn.LayerNorm(cfg.d_model)
        self.norm_2 = nn.LayerNorm(cfg.d_model)
        self.stc_exp = StaticExpansionBlock(cfg)
        self.ff = FeedForward(cfg)

    def forward(self, x, mask: Optional[torch.Tensor], dtype=None, train: bool = False,
                generator=None) -> torch.Tensor:
        eps, rate = self.cfg.ln_eps, self.cfg.drop.enc
        stc = self.stc_exp(layernorm(self.norm_1, x, eps), mask, dtype, train, generator)
        x = x + dropout(stc.to(x.dtype), rate, train, generator)
        ff = self.ff(layernorm(self.norm_2, x, eps), dtype, rate, train, generator)
        return x + dropout(ff.to(x.dtype), rate, train, generator)


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer: dynamic expansion, cross-MHA, FF (reference
    models/layers.py:222-248)."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        self.norm_1 = nn.LayerNorm(cfg.d_model)
        self.norm_2 = nn.LayerNorm(cfg.d_model)
        self.norm_3 = nn.LayerNorm(cfg.d_model)
        self.dyn_exp = DynamicExpansionBlock(cfg)
        self.mha = MultiHeadAttention(cfg)
        self.ff = FeedForward(cfg)

    def forward(self, x, cross_x, self_mask, cross_mask, dtype=None, train: bool = False,
                generator=None) -> torch.Tensor:
        eps, rate = self.cfg.ln_eps, self.cfg.drop.dec
        dyn = self.dyn_exp(layernorm(self.norm_1, x, eps), self_mask, dtype, train, generator)
        x = x + dropout(dyn.to(x.dtype), rate, train, generator)
        x2 = layernorm(self.norm_2, x, eps)
        mha = self.mha(x2, cross_x, cross_x, cross_mask, dtype)
        x = x + dropout(mha.to(x.dtype), rate, train, generator)
        ff = self.ff(layernorm(self.norm_3, x, eps), dtype, rate, train, generator)
        return x + dropout(ff.to(x.dtype), rate, train, generator)
