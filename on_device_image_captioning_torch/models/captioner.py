"""ExpansionNet v2 caption head: encoder / decoder stacks with layer-concat
fusion (counterpart of the JAX package's `models/captioner.py`).

Parameter names are the reference repo's (models/End_ExpansionNet_v2.py), so
`params/torch_convert.py::convert_captioner` in the JAX package reads this
module's state_dict as it reads a reference checkpoint.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config import CaptionerConfig
from ..ops.masks import causal_pad_mask, pad_mask
from .common import dropout, embedding, layernorm, linear
from .expansion import DecoderLayer, EncoderLayer


class EmbeddingLayer(nn.Module):
    """Token embedding holder; the reference names it `out_embedder.embed`."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embed = nn.Embedding(num, dim)


class ExpansionNetV2(nn.Module):
    """Caption head over visual features (reference models/ExpansionNet_v2.py)."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cap_cfg = cfg
        d = cfg.d_model
        self.input_linear = nn.Linear(cfg.img_feature_dim, d)
        self.vocab_linear = nn.Linear(d, cfg.vocab_size)
        self.out_embedder = EmbeddingLayer(cfg.vocab_size, d)
        self.pos_encoder = nn.Embedding(cfg.max_seq_len, d)
        self.enc_reduce_group = nn.Linear(d * cfg.N_enc, d)
        self.enc_reduce_norm = nn.LayerNorm(d)
        self.dec_reduce_group = nn.Linear(d * cfg.N_dec, d)
        self.dec_reduce_norm = nn.LayerNorm(d)
        self.encoders = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.N_enc))
        self.decoders = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.N_dec))

    def forward_enc(
        self,
        features: torch.Tensor,
        enc_num_pads: Optional[torch.Tensor] = None,
        dtype: Optional[torch.dtype] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """features (B, S_enc, img_feature_dim) -> (B, S_enc, d_model)
        (reference models/ExpansionNet_v2.py:77-101). The dropouts (rates of
        `cfg.drop`) are off unless `train` and a generator is given."""
        cfg = self.cap_cfg
        b, s, _ = features.shape
        x = dropout(linear(self.input_linear, features, dtype), cfg.drop.enc_input, train,
                    generator)
        mask = None
        if enc_num_pads is not None:
            mask = pad_mask(b, cfg.sum_exp_enc, s, col_pads=enc_num_pads, device=x.device)
        x_list = []
        for layer in self.encoders:
            x = layer(x, mask, dtype, train, generator)
            x_list.append(x)
        x = x + dropout(linear(self.enc_reduce_group, torch.cat(x_list, dim=-1), dtype),
                        cfg.drop.other, train, generator)
        return layernorm(self.enc_reduce_norm, x, cfg.ln_eps)

    def forward_dec(
        self,
        cross_input: torch.Tensor,
        dec_input: torch.Tensor,
        dec_num_pads: Optional[torch.Tensor] = None,
        enc_num_pads: Optional[torch.Tensor] = None,
        apply_log_softmax: bool = False,
        dtype: Optional[torch.dtype] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Decoder over a full token prefix (reference
        models/ExpansionNet_v2.py:103-156). cross_input (B, S_enc, d);
        dec_input (B, T) ids. Returns logits (B, T, vocab), log-softmaxed in
        fp32 when apply_log_softmax."""
        cfg = self.cap_cfg
        b, t = dec_input.shape
        dev = cross_input.device
        self_mask = causal_pad_mask(b, t, dec_num_pads, device=dev)
        cross_mask = None
        if dec_num_pads is not None or enc_num_pads is not None:
            cross_mask = pad_mask(
                b, t, cross_input.shape[1], row_pads=dec_num_pads,
                col_pads=enc_num_pads, device=dev,
            )
        y = dropout(embedding(self.out_embedder.embed, dec_input), cfg.drop.dec_input,
                    train, generator) * math.sqrt(float(cfg.d_model))
        y = y + self.pos_encoder.weight[:t][None]
        y_list = []
        for layer in self.decoders:
            y = layer(y, cross_input, self_mask, cross_mask, dtype, train, generator)
            y_list.append(y)
        y = y + dropout(linear(self.dec_reduce_group, torch.cat(y_list, dim=-1), dtype),
                        cfg.drop.other, train, generator)
        y = layernorm(self.dec_reduce_norm, y, cfg.ln_eps)
        y = linear(self.vocab_linear, y, dtype)
        if apply_log_softmax:
            y = torch.log_softmax(y.float(), dim=-1)
        return y

    def forward(
        self,
        features: torch.Tensor,
        dec_input: torch.Tensor,
        enc_num_pads: Optional[torch.Tensor] = None,
        dec_num_pads: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        apply_log_softmax: bool = False,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """Full teacher-forced forward over features (the JAX package's
        `captioner.forward`, reference models/captioning_model.py:34-37):
        features (B, S_enc, img_feature_dim) and a token prefix (B, T) ->
        logits (B, T, vocab). The encoder's dropouts are drawn from
        `generator` first, then the decoder's (off without one)."""
        cross = self.forward_enc(features, enc_num_pads, dtype, train, generator)
        return self.forward_dec(cross, dec_input, dec_num_pads, enc_num_pads, apply_log_softmax,
                                dtype, train, generator)
