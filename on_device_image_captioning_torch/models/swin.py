"""Swin Transformer backbone, inference and training (counterpart of the JAX
package's `models/swin.py`), on either of two paths chosen by
`SwinConfig.attention_impl`.

"pallas": NHWC layout; the patch-embed conv (stride == kernel) is a
space-to-depth reshape plus one matmul; the cyclic shift is `torch.roll`;
window partition and reverse are reshapes; the attention core of every block
is kernel K1 (`ops/window_attention.py`), with the qkv and proj GEMMs left to
`torch.matmul`.

"fused": the window-resident path (`_swin_apply_window_resident` and
`_run_stage_fused_windows` of the JAX file). Activations enter window layout
at the patch-embed kernel and stay there. Every block of a multi-window stage
runs in the stage's mode: "full", the whole-block kernel, or "halves", the
attention-half kernel and the MLP-half kernel; either reads its input through
the shift transition from the previous block's layout. A stage ends with the
standalone transition back to shift 0 and the downsample kernel, and a
single-window stage (Swin-L stage 3), whose window layout is the flat layout,
runs as on the "pallas" path. The mode of a stage is "full" up to a width of
384 and "halves" above, which is what the JAX package picks at Swin-L in bf16
(`_stage_fused_mode`); `SwinTransformer(cfg, stage_modes={stage: mode})`
overrides it per stage, as `set_stage_mode_override` does there.

Quantized serving (`deploy/quantization.py`) takes the route the JAX package
takes once its boundary plan gives up on quantized weights: when the patch
embed or a patch merging is a `QuantLinear`, the "fused" path runs stage by
stage (`_forward_stagewise`, `swin_apply` -> `_run_stage` there): the plain
patch embed and patch merging through `linear` (int8 products, fp32 out), each
multi-window stage window-resident between a partition at its entry and a
reverse at its exit, the single-window stage on plain blocks. Inside a
multi-window stage a block whose MLP is w8a8 runs the halves with B13 in
place of B5 (`_stage_fused_mode` / `swin_block` pick "halves" for it there);
the attention half, and under "w8" the MLP half or the whole block, read the
weights dequantized in the compute dtype (`_weight` there).

Training (`forward(..., train=True)`, `_run_stage_fused_windows_train` of the
JAX file): the patch embed, the patch merging, the final norm and the
single-window stage are plain tensor code under autograd. On the "fused" path
every multi-window stage runs window-resident: partitioned once, each block a
differentiable transition (`window_transition_train`) and then the
whole-block training kernel ("full") or the two training halves ("halves"),
whose backwards are kernels too; the relative-position bias is gathered from
its table per block, so the table's gradient flows through the gather.
Stochastic depth is per image: a block takes two (B,) fp32 scales, drawn from
the caller's `torch.Generator` or handed in through `drop_path_scales`.
Nonzero `drop_rate` or `attn_drop_rate` send every stage to the plain block,
as `_fused_train_mode` does. `attention_impl="pallas"` trains on the plain
backbone under autograd.

Parameter and module names are the reference repo's
(models/swin_transformer_mod.py), so its state_dict loads unchanged once the
non-parameter buffers (`attn_mask`, `relative_position_index`) are dropped.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SwinConfig
from ..deploy.quantization import QuantLinear, is_a8
from ..ops.stage_boundary import downsample_fused, patch_embed_fused
from ..ops.swin_block_fused import (
    swin_attn_half, swin_attn_half_train, swin_block, swin_block_train, swin_mlp_half,
    swin_mlp_half_a8, swin_mlp_half_train, window_transition, window_transition_train,
)
from ..ops.window_attention import window_attention
from ..ops.window_layout import window_partition, window_reverse
from .common import column_cut, drop_path_scale, dropout, f32_einsum, layernorm, linear


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


STAGE_MODES = ("full", "halves")
# the widest stage the whole-block kernel takes
FULL_MODE_MAX_WIDTH = 384


def default_stage_mode(width: int) -> str:
    """Mirrors the JAX package's `eligible` (ops/swin_block_fused.py) at
    Swin-L in bf16: a stage whose whole weight set fits its kernel's budget
    (widths 192 and 384) runs the whole-block kernel, a wider one the halves.
    The rule is the width alone; no memory model of the TPU is carried over."""
    return "full" if width <= FULL_MODE_MAX_WIDTH else "halves"


def _norm_operands(norm: nn.LayerNorm):
    return norm.weight.detach(), norm.bias.detach()


def _linear_operands(layer: nn.Module, dtype):
    """(in, out) weight in the compute dtype and the fp32 bias, as the fused
    kernels read them; a `QuantLinear`'s weight dequantized in that dtype."""
    if isinstance(layer, QuantLinear):
        return layer.dequantized(dtype).t().contiguous(), layer.bias
    w = layer.weight.detach().to(dtype).t().contiguous()
    return w, None if layer.bias is None else layer.bias.detach()


def _a8_operands(layer: QuantLinear, dtype=None):
    """(w_q (out, in) int8, scale fp32, bias fp32 or None) of B13."""
    return layer.w_q, layer.scale, layer.bias


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
        """images NHWC (B, H, W, C) -> (B, (H/P)*(W/P), embed_dim); fp32 when
        the projection is quantized (its int8 product ignores `dtype`)."""
        b, h, w, c = images.shape
        ps = self.cfg.patch_size
        x = images.reshape(b, h // ps, ps, w // ps, ps, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // ps) * (w // ps), ps * ps * c)
        if isinstance(self.proj, QuantLinear):
            x = linear(self.proj, x)
        else:
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
        self.attn_drop, self.proj_drop = cfg.attn_drop_rate, cfg.drop_rate
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
        # (first head, whole heads) where the heads are cut over a model axis
        # (`parallel/mesh.py::shard_model`): the probabilities' dropout draws
        # every head's mask and keeps the rank's
        self.head_cut = None

    def bias(self) -> torch.Tensor:
        if self.rel_bias_x is not None:
            return self.rel_bias_x
        return expand_rel_bias(self.relative_position_bias_table, self.relative_position_index)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype=None) -> torch.Tensor:
        """x (B*nW, N, C) -> (B*nW, N, C); mask (nW, N, N) additive or None."""
        qkv = linear(self.qkv, x, dtype)
        out = window_attention(qkv, self.bias(), mask, self.heads, float(self.scale))
        return linear(self.proj, out, dtype)

    def table_bias(self) -> torch.Tensor:
        """The (H, N, N) bias gathered from the table under autograd (never
        the pre-expanded copy): the table's gradient flows through the gather."""
        return expand_rel_bias(self.relative_position_bias_table, self.relative_position_index)

    def forward_train(self, x, mask, dtype=None, generator=None) -> torch.Tensor:
        """The plain attention of the training path (the JAX package's
        `window_attention` with `train`): q scaled in the compute dtype, scores
        and softmax in fp32, dropout on the probabilities and on the output."""
        bw, n, _ = x.shape
        qkv = linear(self.qkv, x, dtype)
        dk = qkv.shape[-1] // (3 * self.heads)  # the rank's heads where they are cut
        q, k, v = qkv.reshape(bw, n, 3, self.heads, dk).permute(2, 0, 3, 1, 4)
        attn = f32_einsum("bhnd,bhmd->bhnm", q * float(self.scale), k) + self.table_bias()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, self.heads, n, n) + mask[None, :, None]
            attn = attn.reshape(bw, self.heads, n, n)
        cut = None if self.head_cut is None else (1, *self.head_cut)
        attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop, True, generator, cut)
        out = f32_einsum("bhnm,bhmd->bhnd", attn.to(v.dtype), v).to(v.dtype)
        out = linear(self.proj, out.transpose(1, 2).reshape(bw, n, self.heads * dk), dtype)
        return dropout(out, self.proj_drop, True, generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype=None, drop: float = 0.0, train: bool = False,
                generator=None) -> torch.Tensor:
        h = linear(self.fc1, x, dtype)
        h = F.gelu(h.float()).to(h.dtype)  # exact-erf GELU in fp32
        h = dropout(h, drop, train, generator, column_cut(self.fc1))
        return dropout(linear(self.fc2, h, dtype), drop, train, generator)


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
        self.mode = default_stage_mode(dim)  # of the stage; SwinTransformer may override

    @property
    def mlp_a8(self) -> bool:
        """A w8a8 MLP: the block runs the halves, its MLP half on kernel B13."""
        return is_a8(self.mlp.fc1)

    @property
    def run_mode(self) -> str:
        """The mode this block runs in on the "fused" path."""
        return "halves" if self.mlp_a8 else self.mode

    def fused_operands(self, dtype):
        """The block kernels' operands (whole block or halves): LayerNorm
        parameters and (in, out) weights in the compute dtype (a w8a8 MLP's
        int8 weights as they are). Prepared once by prepare_inference(); built
        per call otherwise."""
        cached = self.fused_cache
        if cached is not None and cached[:2] == (dtype, self.norm1.weight.device):
            return cached[2]
        mlp = _a8_operands if self.mlp_a8 else _linear_operands
        return {
            "norm1": _norm_operands(self.norm1),
            "qkv": _linear_operands(self.attn.qkv, dtype),
            "proj": _linear_operands(self.attn.proj, dtype),
            "norm2": _norm_operands(self.norm2),
            "fc1": mlp(self.mlp.fc1, dtype),
            "fc2": mlp(self.mlp.fc2, dtype),
        }

    def forward_windows(self, xw: torch.Tensor, from_shift: int) -> torch.Tensor:
        """One block on window-resident activations (B*nW, N, C) that lie in
        the from_shift layout; the result lies in this block's shift layout."""
        ops = self.fused_operands(xw.dtype)
        transition = None if from_shift == self.shift else (self.res, from_shift, self.shift)
        if self.run_mode == "full":
            return swin_block(
                xw, ops["norm1"], ops["qkv"], ops["proj"], ops["norm2"], ops["fc1"], ops["fc2"],
                self.attn.bias(), self.attn_mask, self.attn.heads, float(self.attn.scale),
                self.cfg.ln_eps, transition,
            )
        xw = swin_attn_half(
            xw, ops["norm1"], ops["qkv"], ops["proj"], self.attn.bias(), self.attn_mask,
            self.attn.heads, float(self.attn.scale), self.cfg.ln_eps, transition,
        )
        mlp_half = swin_mlp_half_a8 if self.mlp_a8 else swin_mlp_half
        return mlp_half(xw, ops["norm2"], ops["fc1"], ops["fc2"], self.cfg.ln_eps)

    def forward_windows_train(self, xw: torch.Tensor, m1: torch.Tensor,
                              m2: torch.Tensor) -> torch.Tensor:
        """One training block on window-resident activations already in this
        block's shift layout, with the per-image scales m1, m2 (B,) on its two
        branches; differentiable (the backwards are kernels on the card)."""
        attn, mlp, eps = self.attn, self.mlp, self.cfg.ln_eps
        norm1 = (self.norm1.weight, self.norm1.bias)
        norm2 = (self.norm2.weight, self.norm2.bias)
        # (in, out) views of the master weights: cast once per call inside
        qkv, proj = (attn.qkv.weight.t(), attn.qkv.bias), (attn.proj.weight.t(), attn.proj.bias)
        fc1, fc2 = (mlp.fc1.weight.t(), mlp.fc1.bias), (mlp.fc2.weight.t(), mlp.fc2.bias)
        bias, scale = attn.table_bias(), float(attn.scale)
        if self.mode == "full":
            return swin_block_train(xw, norm1, qkv, proj, norm2, fc1, fc2, bias, self.attn_mask,
                                    m1, m2, attn.heads, scale, eps)
        xw = swin_attn_half_train(xw, norm1, qkv, proj, bias, self.attn_mask, m1, attn.heads,
                                  scale, eps)
        return swin_mlp_half_train(xw, norm2, fc1, fc2, m2, eps)

    def forward_train(self, x: torch.Tensor, dtype, m1: torch.Tensor, m2: torch.Tensor,
                      generator=None) -> torch.Tensor:
        """The plain training block (the JAX package's `swin_block` off the
        kernels): dropouts from the generator, the per-image scales m1, m2 on
        the two branches."""
        b, l, c = x.shape
        res, window, shift = self.res, self.window, self.shift
        eps, drop = self.cfg.ln_eps, self.cfg.drop_rate

        def scaled(h, m):
            return (h.float() * m[:, None, None]).to(h.dtype)

        h = layernorm(self.norm1, x, eps).reshape(b, res, res, c)
        if shift > 0:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
        h = self.attn.forward_train(window_partition(h, window), self.attn_mask, dtype, generator)
        h = window_reverse(h, window, res, res)
        if shift > 0:
            h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
        x = x + scaled(h.reshape(b, l, c), m1)
        h = self.mlp(layernorm(self.norm2, x, eps), dtype, drop, True, generator)
        return x + scaled(h, m2)

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


def _remat_block(blk, x, dtype, m1, m2, generator) -> torch.Tensor:
    """`blk.forward_train` under activation checkpointing. The dropout masks
    come from an explicit generator, which `preserve_rng_state` does not
    cover: its state before the forward is kept and put back for the
    recompute, so the recompute draws the forward's masks, and the state
    the forward left is put back after it, so later draws do not move."""
    from torch.utils.checkpoint import checkpoint

    before = None if generator is None else generator.get_state()
    calls = []

    def run(x, m1, m2):
        if not calls or before is None:
            calls.append(None)
            return blk.forward_train(x, dtype, m1, m2, generator)
        after = generator.get_state()
        generator.set_state(before)
        try:
            return blk.forward_train(x, dtype, m1, m2, generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, x, m1, m2, use_reentrant=False)


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

    def __init__(self, cfg: SwinConfig, stage_modes: Optional[Dict[int, str]] = None):
        """stage_modes: {stage index: "full" | "halves"} for the "fused" path,
        overriding `default_stage_mode` for those stages."""
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
        for stage, mode in (stage_modes or {}).items():
            if mode not in STAGE_MODES or not 0 <= stage < cfg.num_layers:
                raise ValueError(
                    f"stage_modes[{stage!r}] = {mode!r}; expected a stage index and one of "
                    f"{STAGE_MODES}")
            for blk in self.layers[stage].blocks:
                blk.mode = mode

    @property
    def stage_modes(self) -> Dict[int, str]:
        """The mode of every multi-window stage on the "fused" path."""
        return {i: layer.blocks[0].run_mode for i, layer in enumerate(self.layers)
                if layer.blocks[0].res > layer.blocks[0].window}

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
        lay out every multi-window block's weights for the block kernels
        (whole block or halves) in `dtype` (the compute dtype; fp32 when
        None). Inference only: call again after the weights change or move."""
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

    def _quantized_boundaries(self) -> bool:
        """Whether the patch embed or a patch merging is quantized: the JAX
        package's `_boundary_fused_plan` then gives up (it needs their dense
        weights) and `swin_apply` runs stage by stage."""
        return isinstance(self.patch_embed.proj, QuantLinear) or any(
            isinstance(layer.downsample.reduction, QuantLinear)
            for layer in self.layers if layer.downsample is not None)

    def _run_stage_windows(self, layer, x: torch.Tensor, dtype) -> torch.Tensor:
        """A multi-window stage of the stage-by-stage route (`_run_stage_fused_
        windows` of the JAX file): partition at entry in the compute dtype, the
        blocks window-resident, the transition back to shift 0, reverse."""
        b, l, c = x.shape
        res, window = layer.blocks[0].res, layer.blocks[0].window
        xw = window_partition(x.reshape(b, res, res, c), window)
        if dtype is not None:
            xw = xw.to(dtype)
        xw = xw.contiguous()
        shift = 0
        for blk in layer.blocks:
            xw = blk.forward_windows(xw, shift)
            shift = blk.shift
        if shift != 0:
            xw = window_transition(xw, res, window, shift, 0)
        return window_reverse(xw, window, res, res).reshape(b, l, c)

    def _forward_stagewise(self, images: torch.Tensor, dtype=None) -> torch.Tensor:
        """The "fused" path with quantized boundaries (see the module
        docstring): plain patch embed and patch merging, multi-window stages
        window-resident, the single-window stage on plain blocks."""
        x = self.patch_embed(images, dtype)
        for layer in self.layers:
            if layer.blocks[0].res > layer.blocks[0].window:
                x = self._run_stage_windows(layer, x, dtype)
            else:
                for blk in layer.blocks:
                    x = blk(x, dtype)
            if layer.downsample is not None:
                x = layer.downsample(x, dtype)
        return layernorm(self.norm, x, self.cfg.ln_eps)

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

    def _run_stage_windows_train(self, layer, x, scales, dtype) -> torch.Tensor:
        """A multi-window stage of the "fused" training path: partition once,
        then per block a differentiable transition and the training kernels."""
        b, l, c = x.shape
        res, window = layer.blocks[0].res, layer.blocks[0].window
        xw = window_partition(x.reshape(b, res, res, c), window)
        if dtype is not None:
            xw = xw.to(dtype)
        xw = xw.contiguous()
        shift = 0
        for blk, (m1, m2) in zip(layer.blocks, scales):
            xw = window_transition_train(xw, res, window, shift, blk.shift)
            xw = blk.forward_windows_train(xw, m1, m2)
            shift = blk.shift
        xw = window_transition_train(xw, res, window, shift, 0)
        return window_reverse(xw, window, res, res).reshape(b, l, c)

    def _forward_train(self, images, dtype, generator, drop_path_scales,
                       remat=False) -> torch.Tensor:
        cfg = self.cfg
        b = images.shape[0]
        total = sum(cfg.depths)
        if drop_path_scales is None:
            # the stochastic depth decay rule: the rate grows linearly with depth
            rates = [cfg.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
            drop_path_scales = [
                (drop_path_scale(r, b, generator, images.device),
                 drop_path_scale(r, b, generator, images.device)) for r in rates]
        elif len(drop_path_scales) != total:
            raise ValueError(f"drop_path_scales: want {total} (m1, m2) pairs, one per block")
        x = self.patch_embed(images, dtype)
        if cfg.ape:
            x = x + self.absolute_pos_embed
        x = dropout(x, cfg.drop_rate, True, generator)
        kernels = (cfg.attention_impl == "fused" and cfg.drop_rate == 0.0
                   and cfg.attn_drop_rate == 0.0)
        first = 0
        for layer in self.layers:
            scales = drop_path_scales[first:first + len(layer.blocks)]
            first += len(layer.blocks)
            if kernels and layer.blocks[0].res > layer.blocks[0].window:
                x = self._run_stage_windows_train(layer, x, scales, dtype)
            else:
                # remat only here: the training kernels recompute in their own
                # backwards (the JAX package's `_fused_train_active` gate)
                for blk, (m1, m2) in zip(layer.blocks, scales):
                    x = (_remat_block(blk, x, dtype, m1, m2, generator) if remat
                         else blk.forward_train(x, dtype, m1, m2, generator))
            if layer.downsample is not None:
                x = layer.downsample(x, dtype)
        return layernorm(self.norm, x, cfg.ln_eps)

    def forward(
        self, images: torch.Tensor, dtype=None, train: bool = False,
        generator: Optional[torch.Generator] = None,
        drop_path_scales: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """train=True is the differentiable training forward: dropout and
        stochastic depth are drawn from `generator` (none without one), or the
        per-block (m1, m2) scales, each (B,) fp32, are handed in through
        `drop_path_scales` (one pair per block, in network order). remat=True
        keeps only each plain block's input and recomputes the block in the
        backward (`torch.utils.checkpoint`; the JAX package's `jax.checkpoint`
        of the blocks off the training kernels), with the same dropout
        masks."""
        if train:
            return self._forward_train(images, dtype, generator, drop_path_scales, remat)
        if self.cfg.attention_impl == "fused":
            if self._quantized_boundaries():
                return self._forward_stagewise(images, dtype)
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
