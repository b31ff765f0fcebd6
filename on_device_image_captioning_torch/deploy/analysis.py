"""Analytic parameter and FLOP accounting (counterpart of the JAX package's
`deploy/analysis.py`, formula for formula).

Mirrors the reference's hand-written flops() methods (reference
models/swin_transformer_mod.py:277-288, 451-463, 506-510, 602-608, 656-667,
820-827 — which count multiply-accumulates once, i.e. MAC-style "FLOPs", the same
convention thop uses in benchmarking/benchmarking.py:24-55) and extends the
accounting to the expansion caption head and both decode strategies, so the
reference-vs-rebuild decode cost ratio is quantifiable. The counts are of the
model, not of a device: a share of the card's peak (MFU) divides a measured
rate by them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

from ..config import CaptionerConfig, ModelConfig, SwinConfig
from ..models.swin import effective_window


def param_count(model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Elements of every parameter of a module, or of every tensor of a
    state_dict (the reference's names: parameters only, no buffers)."""
    if isinstance(model_or_state_dict, nn.Module):
        return int(sum(p.numel() for p in model_or_state_dict.parameters()))
    return int(sum(t.numel() for t in model_or_state_dict.values()
                   if isinstance(t, torch.Tensor)))


# ---------------------------------------------------------------------------
# Swin (same formulas as the reference's per-module methods)
# ---------------------------------------------------------------------------


def swin_flops(cfg: SwinConfig) -> int:
    total = 0
    ho, wo = cfg.patches_resolution
    # patch embed (reference :656-667)
    total += ho * wo * cfg.embed_dim * cfg.in_chans * cfg.patch_size**2
    if cfg.patch_norm:
        total += ho * wo * cfg.embed_dim
    for i, depth in enumerate(cfg.depths):
        dim = cfg.stage_dim(i)
        h = w = cfg.stage_resolution(i)[0]
        heads = cfg.num_heads[i]
        for j in range(depth):
            window, _ = effective_window(cfg, i, j)
            n = window * window
            nw = h * w / n
            # attention (reference :277-288)
            attn = n * dim * 3 * dim + heads * n * (dim // heads) * n * 2 + n * dim * dim
            # block (reference :451-463)
            total += dim * h * w  # norm1
            total += int(nw * attn)
            total += int(2 * h * w * dim * dim * cfg.mlp_ratio)  # mlp
            total += dim * h * w  # norm2
        if i < cfg.num_layers - 1:  # patch merging (reference :506-510)
            total += h * w * dim + (h // 2) * (w // 2) * 4 * dim * 2 * dim
    # the reference's total excludes the final norm (commented out at :825-826)
    return int(total)


# ---------------------------------------------------------------------------
# Expansion caption head
# ---------------------------------------------------------------------------


def encoder_flops(cfg: CaptionerConfig, s_enc: int) -> int:
    d, e = cfg.d_model, cfg.sum_exp_enc
    per_layer = (
        4 * s_enc * d * d          # key/class_a/class_b/selector projections
        + 2 * e * s_enc * d        # z and its transpose use (fw + bw matmuls count below)
        + 2 * e * s_enc * d        # class_a/b forward aggregation
        + 2 * s_enc * e * d        # backward aggregation
        + 2 * s_enc * d * cfg.ff   # feed-forward
    )
    total = cfg.N_enc * per_layer
    total += s_enc * cfg.img_feature_dim * d  # input_linear
    total += s_enc * (cfg.N_enc * d) * d      # enc_reduce_group
    return int(total)


def decoder_flops_full_prefix(cfg: CaptionerConfig, t: int, s_enc: int) -> int:
    """One full-prefix forward_dec over t tokens (what the reference pays per
    decode step, models/captioning_model.py:290-399)."""
    d, e = cfg.d_model, cfg.num_exp_dec
    per_layer = (
        5 * t * d * d              # cond/key/class_a/class_b/selector
        + 2 * (t * e) * t * d      # z fw + its consumption
        + 2 * t * (t * e) * d      # bw aggregation
        + 2 * t * d * d            # cross-attn q + out proj
        + 2 * s_enc * d * d        # cross-attn k/v proj (recomputed every call!)
        + 2 * t * s_enc * d        # cross-attn scores + values
        + 2 * t * d * cfg.ff       # ff
    )
    total = cfg.N_dec * per_layer
    total += t * (cfg.N_dec * d) * d
    total += t * d * cfg.vocab_size
    return int(total)


def decoder_flops_incremental_step(cfg: CaptionerConfig, t: int, s_enc: int) -> int:
    """One step of the incremental decoder at position t (decode/cache.py)."""
    d, e = cfg.d_model, cfg.num_exp_dec
    per_layer = (
        5 * d * d                  # per-position projections
        + e * t * d                # z forward row block
        + 2 * e * t * d            # fw aggregation
        + t * e * d                # z backward column
        + 2 * t * e * d            # bw aggregation
        + 2 * d * d                # cross-attn q + out
        + 2 * s_enc * d            # cross-attn scores + values
        + 2 * d * cfg.ff
    )
    total = cfg.N_dec * per_layer
    total += (cfg.N_dec * d) * d
    total += d * cfg.vocab_size
    return int(total)


def xe_train_step_flops(
    cfg: ModelConfig, seq_len: int, remat: bool = True
) -> Dict[str, int]:
    """Analytic per-IMAGE MACs of one XE training step (fwd+bwd+remat), same
    MAC-counted-once convention as swin_flops (the reference's flops()
    methods and thop). Backward of a matmul costs ~2x its forward (dgrad +
    wgrad); `remat` adds one forward recompute of every Swin block (the JAX
    package's count, kept as it is: there --remat checkpoints the blocks
    and its training kernels recompute in their backwards; in the port the
    training kernels recompute in theirs and --remat checkpoints the blocks
    off them), so the backbone multiplier is 4x fwd with remat, 3x without;
    the caption head is never rematerialized (3x). Reference hot loop:
    train.py:47-302."""
    cap = cfg.captioner
    s_enc = cfg.swin.stage_resolution(3)[0] ** 2
    backbone_fwd = swin_flops(cfg.swin)
    head_fwd = encoder_flops(cap, s_enc) + decoder_flops_full_prefix(
        cap, seq_len, s_enc
    )
    backbone = (4 if remat else 3) * backbone_fwd
    head = 3 * head_fwd
    return {
        "backbone_fwd": backbone_fwd,
        "head_fwd": head_fwd,
        "backbone_train": int(backbone),
        "head_train": int(head),
        "total": int(backbone + head),
    }


def scst_train_step_flops(
    cfg: ModelConfig, scst_len: int, num_samples: int, remat: bool = True
) -> Dict[str, int]:
    """Analytic per-IMAGE MACs of one fused shared-forward SCST step
    (train/train_step.py make_scst_fused_step): ONE train-mode encoder
    forward shared between sampling and re-score, num_samples incremental
    sampling decodes (no grad), a decoder-only re-score fwd+bwd (3x) over
    the num_samples sampled rows, and the encoder's backward from the
    re-score's gradient (2x fwd, +1x recompute under remat)."""
    cap = cfg.captioner
    s_enc = cfg.swin.stage_resolution(3)[0] ** 2
    enc_fwd = swin_flops(cfg.swin) + encoder_flops(cap, s_enc)
    sample = num_samples * (
        sum(
            decoder_flops_incremental_step(cap, t + 1, s_enc)
            for t in range(scst_len)
        )
        + cap.N_dec * 2 * s_enc * cap.d_model * cap.d_model  # K/V once
    )
    rescore = 3 * num_samples * decoder_flops_full_prefix(cap, scst_len, s_enc)
    enc_bwd = (3 if remat else 2) * enc_fwd
    return {
        "encoder_fwd": int(enc_fwd),
        "sampling": int(sample),
        "rescore_train": int(rescore),
        "encoder_bwd": int(enc_bwd),
        "total": int(enc_fwd + sample + rescore + enc_bwd),
    }


def beam_search_flops(
    cfg: ModelConfig, beam: int, steps: int, incremental: bool = True
) -> Dict[str, int]:
    """End-to-end single-image captioning cost breakdown; `incremental=False`
    reproduces the reference's strategy for comparison."""
    cap = cfg.captioner
    s_enc = cfg.swin.stage_resolution(3)[0] ** 2
    backbone = swin_flops(cfg.swin)
    encoder = encoder_flops(cap, s_enc)
    if incremental:
        dec = sum(
            beam * decoder_flops_incremental_step(cap, t + 1, s_enc)
            for t in range(steps)
        )
        dec += cap.N_dec * 2 * s_enc * cap.d_model * cap.d_model  # K/V once
    else:
        dec = sum(
            beam * decoder_flops_full_prefix(cap, t + 1, s_enc)
            for t in range(steps)
        )
    return {
        "backbone": backbone,
        "encoder": encoder,
        "decode": int(dec),
        "total": int(backbone + encoder + dec),
    }
