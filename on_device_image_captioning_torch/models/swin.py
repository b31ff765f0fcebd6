"""Swin Transformer backbone, inference path (counterpart of the JAX package's
`models/swin.py`), on either of two paths chosen by `SwinConfig.attention_impl`.

"pallas": NHWC layout; the patch-embed conv (stride == kernel) is a
space-to-depth reshape plus one matmul; the cyclic shift is `torch.roll`;
window partition and reverse are reshapes; the attention core of every block
is kernel K1 (`ops/window_attention.py`), with the qkv and proj GEMMs left to
`torch.matmul`.

"fused": the window-resident path (`_swin_apply_window_resident` and
`_run_stage_fused_windows` of the JAX file, in its `halves` mode). Activations
enter window layout at the patch-embed kernel and stay there: every block of
a multi-window stage is the attention-half kernel (reading its input through
the shift transition from the previous block's layout) and the MLP-half
kernel, a stage ends with the standalone transition back to shift 0 and the
downsample kernel, and a single-window stage (Swin-L stage 3), whose window
layout is the flat layout, runs as on the "pallas" path.

Parameter and module names are the reference repo's
(models/swin_transformer_mod.py), so its state_dict loads unchanged once the
non-parameter buffers (`attn_mask`, `relative_position_index`) are dropped.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SwinConfig
from ..ops.stage_boundary import downsample_fused, patch_embed_fused
from ..ops.swin_block_fused import swin_attn_half, swin_mlp_half, window_transition
from ..ops.window_attention import window_attention
from ..ops.window_layout import window_partition, window_reverse
from .common import layernorm, linear


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """(N, N) gather indices into the (2W-1)^2 bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(window_size), np.arange(window_size), indexing="ij")
    )
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(resolution: int, window_size: int, shift_size: int) -> np.ndarray:
    """Additive (-100 / 0) mask (nW, N, N) for wrap-around windows after the
    cyclic shift."""
    img_mask = np.zeros((resolution, resolution))
    slices = (
        slice(0, -window_size),
        slice(-window_size, -shift_size),
        slice(-shift_size, None),
    )
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    nw = resolution // window_size
    windows = (
        img_mask.reshape(nw, window_size, nw, window_size)
        .transpose(0, 2, 1, 3)
        .reshape(-1, window_size * window_size)
    )
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def effective_window(cfg: SwinConfig, stage: int, block: int):
    """Per-block (window_size, shift_size): when the stage resolution is <=
    the window, the whole grid is one window and the shift is disabled
    (Swin-L stage 3 at 384: resolution 12 == window 12)."""
    res = cfg.stage_resolution(stage)[0]
    window = cfg.window_size
    shift = 0 if block % 2 == 0 else cfg.window_size // 2
    if res <= window:
        window, shift = res, 0
    return window, shift


def _norm_operands(norm: nn.LayerNorm):
    return norm.weight.detach(), norm.bias.detach()


def _linear_operands(layer: nn.Linear, dtype):
    """(in, out) weight in the compute dtype and the fp32 bias, as the fused
    kernels read them."""
    w = layer.weight.detach().to(dtype).t().contiguous()
    return w, None if layer.bias is None else layer.bias.detach()


def expand_rel_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """((2W-1)^2, H) table -> the (H, N, N) fp32 bias the attention core reads."""
    n = index.shape[0]
    heads = table.shape[-1]
    bias = table[index.reshape(-1)].reshape(n, n, heads)
    return bias.permute(2, 0, 1).float().contiguous()


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Conv2d(
            cfg.in_chans, cfg.embed_dim, kernel_size=cfg.patch_size, stride=cfg.patch_size
        )
        self.norm = nn.LayerNorm(cfg.embed_dim) if cfg.patch_norm else None

    def forward(self, images: torch.Tensor, dtype=None) -> torch.Tensor:
        """images NHWC (B, H, W, C) -> (B, (H/P)*(W/P), embed_dim)."""
        b, h, w, c = images.shape
        ps = self.cfg.patch_size
        x = images.reshape(b, h // ps, ps, w // ps, ps, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // ps) * (w // ps), ps * ps * c)
        # conv weight (O, C, kh, kw) -> (O, kh*kw*C) in the (u, v, c) patch order
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        if dtype is not None:
            x = x.to(dtype)
        x = F.linear(x, weight.to(x.dtype), self.proj.bias.to(x.dtype))
        if self.norm is not None:
            x = layernorm(self.norm, x, self.cfg.ln_eps)
        return x

    def fused_operands(self, dtype):
        """(proj, norm) of `patch_embed_fused`: the conv weight as a
        (kh*kw*C, O) matrix in the (u, v, c) patch order."""
        o = self.proj.out_channels
        w = self.proj.weight.detach().permute(0, 2, 3, 1).reshape(o, -1)
        proj = (w.to(dtype).t().contiguous(), self.proj.bias.detach())
        return proj, _norm_operands(self.norm)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int, cfg: SwinConfig):
        super().__init__()
        self.heads = heads
        dk = dim // heads
        self.scale = cfg.qk_scale if cfg.qk_scale is not None else dk**-0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads)
        )
        self.qkv = nn.Linear(dim, 3 * dim, bias=cfg.qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window).astype(np.int64)),
            persistent=False,
        )
        # (H, N, N) bias expanded once by prepare_inference(); None = per call
        self.register_buffer("rel_bias_x", None, persistent=False)

    def bias(self) -> torch.Tensor:
        if self.rel_bias_x is not None:
            return self.rel_bias_x
        return expand_rel_bias(self.relative_position_bias_table, self.relative_position_index)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype=None) -> torch.Tensor:
        """x (B*nW, N, C) -> (B*nW, N, C); mask (nW, N, N) additive or None."""
        qkv = linear(self.qkv, x, dtype)
        out = window_attention(qkv, self.bias(), mask, self.heads, float(self.scale))
        return linear(self.proj, out, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        h = linear(self.fc1, x, dtype)
        h = F.gelu(h.float()).to(h.dtype)  # exact-erf GELU in fp32
        return linear(self.fc2, h, dtype)


class SwinTransformerBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int, block: int):
        super().__init__()
        self.cfg = cfg
        dim = cfg.stage_dim(stage)
        self.res = cfg.stage_resolution(stage)[0]
        self.window, self.shift = effective_window(cfg, stage, block)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, self.window, cfg.num_heads[stage], cfg)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))
        mask = None
        if self.shift > 0:
            mask = torch.from_numpy(shift_attn_mask(self.res, self.window, self.shift))
        self.register_buffer("attn_mask", mask, persistent=False)
        self.fused_cache = None  # (dtype, device, operands), set by prepare_inference()

    def fused_operands(self, dtype):
        """The half-block kernels' operands: LayerNorm parameters and (in,
        out) weights in the compute dtype. Prepared once by
        prepare_inference(); built per call otherwise."""
        cached = self.fused_cache
        if cached is not None and cached[:2] == (dtype, self.norm1.weight.device):
            return cached[2]
        return {
            "norm1": _norm_operands(self.norm1),
            "qkv": _linear_operands(self.attn.qkv, dtype),
            "proj": _linear_operands(self.attn.proj, dtype),
            "norm2": _norm_operands(self.norm2),
            "fc1": _linear_operands(self.mlp.fc1, dtype),
            "fc2": _linear_operands(self.mlp.fc2, dtype),
        }

    def forward_windows(self, xw: torch.Tensor, from_shift: int) -> torch.Tensor:
        """One block on window-resident activations (B*nW, N, C) that lie in
        the from_shift layout; the result lies in this block's shift layout."""
        ops = self.fused_operands(xw.dtype)
        transition = None if from_shift == self.shift else (self.res, from_shift, self.shift)
        xw = swin_attn_half(
            xw, ops["norm1"], ops["qkv"], ops["proj"], self.attn.bias(), self.attn_mask,
            self.attn.heads, float(self.attn.scale), self.cfg.ln_eps, transition,
        )
        return swin_mlp_half(xw, ops["norm2"], ops["fc1"], ops["fc2"], self.cfg.ln_eps)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        b, l, c = x.shape
        res, window, shift = self.res, self.window, self.shift
        eps = self.cfg.ln_eps
        h = layernorm(self.norm1, x, eps).reshape(b, res, res, c)
        if shift > 0:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
        h = self.attn(window_partition(h, window), self.attn_mask, dtype)
        h = window_reverse(h, window, res, res)
        if shift > 0:
            h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
        x = x + h.reshape(b, l, c)
        return x + self.mlp(layernorm(self.norm2, x, eps), dtype)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat (x0, x1, x2, x3 = (even, even), (odd, even),
    (even, odd), (odd, odd)) -> LN(4C) -> linear 4C -> 2C without bias."""

    def __init__(self, cfg: SwinConfig, stage: int):
        super().__init__()
        self.cfg = cfg
        dim = cfg.stage_dim(stage)
        self.res = cfg.stage_resolution(stage)[0]
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        b, l, c = x.shape
        x = x.reshape(b, self.res, self.res, c)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
            dim=-1,
        ).reshape(b, l // 4, 4 * c)
        x = layernorm(self.norm, x, self.cfg.ln_eps)
        return linear(self.reduction, x, dtype)

    def fused_operands(self, dtype):
        """(norm, reduction) of `downsample_fused`."""
        return _norm_operands(self.norm), _linear_operands(self.reduction, dtype)[0]


class BasicLayer(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(cfg, stage, j) for j in range(cfg.depths[stage])
        )
        self.downsample = PatchMerging(cfg, stage) if stage < cfg.num_layers - 1 else None


class SwinTransformer(nn.Module):
    """Backbone without the classification head: images NHWC (B, img, img, 3)
    -> tokens (B, (img/32)^2, num_features)."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.attention_impl == "fused":
            self._check_window_resident()
        self.patch_embed = PatchEmbed(cfg)
        if cfg.ape:
            n = cfg.patches_resolution[0] * cfg.patches_resolution[1]
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, n, cfg.embed_dim))
        self.layers = nn.ModuleList(BasicLayer(cfg, i) for i in range(cfg.num_layers))
        self.norm = nn.LayerNorm(cfg.num_features)

    def _check_window_resident(self) -> None:
        """What the window-resident path needs of a configuration (the JAX
        package's `_boundary_fused_plan`): no absolute position embedding, a
        patch norm, one window size that tiles every stage, and an even window
        grid wherever a stage is followed by a downsample."""
        cfg = self.cfg
        if cfg.ape or not cfg.patch_norm:
            raise ValueError('attention_impl="fused" takes neither ape nor patch_norm=False')
        window = effective_window(cfg, 0, 0)[0]
        for i in range(cfg.num_layers):
            res = cfg.stage_resolution(i)[0]
            last = i == cfg.num_layers - 1
            if effective_window(cfg, i, 0)[0] != window or res % window or (
                not last and (res // window) % 2
            ):
                raise ValueError(
                    f'attention_impl="fused": stage {i} ({res} x {res} tokens) does not '
                    f"tile into windows of {window} that merge 2 x 2"
                )

    def prepare_inference(self, dtype=None) -> None:
        """Expand every block's relative-position bias to (H, N, N) once (the
        JAX package's `prepare_inference_params`) and, on the "fused" path,
        lay out every multi-window block's weights for the half-block kernels
        in `dtype` (the compute dtype; fp32 when None). Inference only: call
        again after the weights change or move."""
        dtype = dtype or torch.float32
        for layer in self.layers:
            for blk in layer.blocks:
                attn = blk.attn
                attn.rel_bias_x = expand_rel_bias(
                    attn.relative_position_bias_table.detach(), attn.relative_position_index
                )
                if self.cfg.attention_impl == "fused" and blk.res > blk.window:
                    blk.fused_cache = None
                    blk.fused_cache = (dtype, blk.norm1.weight.device, blk.fused_operands(dtype))

    def _forward_window_resident(self, images: torch.Tensor, dtype=None) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, cin = images.shape
        ps = cfg.patch_size
        window = effective_window(cfg, 0, 0)[0]
        x = images.reshape(b, h // ps, ps, w // ps, ps, cin).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // ps, w // ps, ps * ps * cin)
        if dtype is not None:
            x = x.to(dtype)
        xw = patch_embed_fused(
            x.contiguous(), *self.patch_embed.fused_operands(x.dtype), window, cfg.ln_eps
        )
        for i, layer in enumerate(self.layers):
            res = cfg.stage_resolution(i)[0]
            if res > window:
                shift = 0
                for blk in layer.blocks:
                    xw = blk.forward_windows(xw, shift)
                    shift = blk.shift
                if shift != 0:  # no next block to fold the way back into
                    xw = window_transition(xw, res, window, shift, 0)
            else:  # one window: window layout is the flat layout
                for blk in layer.blocks:
                    xw = blk(xw, dtype)
            if layer.downsample is not None:
                xw = downsample_fused(
                    xw, *layer.downsample.fused_operands(xw.dtype), res // window, window,
                    cfg.ln_eps,
                )
        res = cfg.stage_resolution(cfg.num_layers - 1)[0]
        if res > window:
            xw = window_reverse(xw, window, res, res)
        return layernorm(self.norm, xw.reshape(b, res * res, -1), cfg.ln_eps)

    def forward(self, images: torch.Tensor, dtype=None) -> torch.Tensor:
        if self.cfg.attention_impl == "fused":
            return self._forward_window_resident(images, dtype)
        x = self.patch_embed(images, dtype)
        if self.cfg.ape:
            x = x + self.absolute_pos_embed
        for layer in self.layers:
            for blk in layer.blocks:
                x = blk(x, dtype)
            if layer.downsample is not None:
                x = layer.downsample(x, dtype)
        return layernorm(self.norm, x, self.cfg.ln_eps)
