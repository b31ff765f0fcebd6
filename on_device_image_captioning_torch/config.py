"""Configuration dataclasses, field for field with the JAX package's
`config.py` (reference: train.py:385-416, demo.py:67-99 of the original repo).

`SwinConfig.attention_impl` selects the backbone path as in the JAX package:
"pallas" (the default here) partitions and rolls per block around the
window-attention kernel; "fused" keeps activations in window layout from the
patch embed on and runs the half-block and stage-boundary kernels. The JAX
package's "xla" and "auto" have no counterpart: the port has no kernel-free
configuration on the card, and so `resolve_kernel_impls` is left out.
`DecodeConfig.chunk_schedule` has the JAX meaning: every decode runs in phases
of growing cache length (`decode/beam_search.py::default_chunk_schedule`).
`remove_layers` is the JAX package's, for the layer-removal ablations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


ATTENTION_IMPLS = ("pallas", "fused")


@dataclasses.dataclass(frozen=True)
class DropConfig:
    """Dropout rates of the caption head (reference: train.py drop_args
    Namespace). Inference ignores them; the training forward (`train=True`
    with a `torch.Generator`) applies them."""

    enc: float = 0.0
    dec: float = 0.0
    enc_input: float = 0.0
    dec_input: float = 0.0
    other: float = 0.0


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin Transformer backbone; defaults are Swin-Large 384."""

    img_size: int = 384
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    ape: bool = False
    patch_norm: bool = True
    ln_eps: float = 1e-5
    attention_impl: str = "pallas"  # "pallas" | "fused" (module docstring)

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"SwinConfig.attention_impl={self.attention_impl!r}; the port has "
                f"{' and '.join(repr(i) for i in ATTENTION_IMPLS)}"
            )

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patches_resolution(self) -> Tuple[int, int]:
        return (self.img_size // self.patch_size, self.img_size // self.patch_size)

    def stage_resolution(self, i: int) -> Tuple[int, int]:
        r = self.patches_resolution
        return (r[0] // (2**i), r[1] // (2**i))

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2**i)


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    """ExpansionNet v2 caption head (reference: models/End_ExpansionNet_v2.py).

    `num_exp_enc_list` are the static-expansion group sizes (their sum is the
    number of expanded encoder slots); `num_exp_dec` is the per-token dynamic
    expansion factor.
    """

    d_model: int = 512
    N_enc: int = 3
    N_dec: int = 3
    ff: int = 2048
    num_heads: int = 8
    num_exp_enc_list: Tuple[int, ...] = (32, 64, 128, 256, 512)
    num_exp_dec: int = 16
    vocab_size: int = 10000
    max_seq_len: int = 74
    img_feature_dim: int = 1536
    sos_idx: int = 79
    eos_idx: int = 77
    pad_idx: int = 78
    unk_idx: int = 80
    drop: DropConfig = dataclasses.field(default_factory=DropConfig)
    eps: float = 1e-9  # expansion normalization eps
    ln_eps: float = 1e-5
    attn_fill: float = -1e4  # attention mask fill

    def __post_init__(self):
        # An out-of-range special token would index past the embedding table;
        # fail at construction instead of producing degenerate captions.
        for name in ("sos_idx", "eos_idx", "pad_idx", "unk_idx"):
            idx = getattr(self, name)
            if not 0 <= idx < self.vocab_size:
                raise ValueError(
                    f"CaptionerConfig.{name}={idx} is outside the vocab "
                    f"(vocab_size={self.vocab_size}); pass in-range special "
                    f"token indices (the 77-80 defaults fit COCO's 10k vocab "
                    f"only)"
                )

    @property
    def sum_exp_enc(self) -> int:
        return int(sum(self.num_exp_enc_list))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full end-to-end model: Swin backbone + caption head.

    compute_dtype is the dtype of the matmul path; parameters stay float32
    and layer norms, softmaxes and L1 normalizations run in float32.
    """

    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    captioner: CaptionerConfig = dataclasses.field(default_factory=CaptionerConfig)
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.captioner.img_feature_dim != self.swin.num_features:
            raise ValueError(
                "captioner.img_feature_dim must equal swin.num_features "
                f"({self.captioner.img_feature_dim} != {self.swin.num_features})"
            )


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decode-time arguments (reference: models/captioning_model.py
    `beam_search_args`)."""

    beam_size: int = 5
    how_many_outputs: int = 1
    max_seq_len: int = 74
    sample_or_max: str = "max"
    sos_idx: int = 79
    eos_idx: int = 77
    # Cache-length schedule of chunked decode: the caches start at
    # chunk_schedule[0] positions and are zero-padded to the next chunk only
    # while some beam still grows. Every step of the decode-step kernels reads
    # and writes every position of the caches it is given, so a step's bytes
    # follow the cache length, not the position. Positions beyond `pos` are
    # masked: tokens equal a single phase's, values up to the order of fp32
    # sums. None = `decode/beam_search.py::default_chunk_schedule(max_seq_len)`;
    # (max_seq_len,) = one phase. Strictly increasing, ending at max_seq_len,
    # every chunk but the last even (the JAX package's rule).
    chunk_schedule: Optional[tuple] = None


def swin_large_384() -> SwinConfig:
    """The Swin-L/384 backbone of every reference entry point."""
    return SwinConfig()


def expansionnet_v2_coco(drop: DropConfig = DropConfig()) -> CaptionerConfig:
    """Caption head as used for COCO (vocab 10k)."""
    return CaptionerConfig(drop=drop)


def end_expansionnet_v2_coco(
    drop: DropConfig = DropConfig(), compute_dtype: torch.dtype = torch.float32
) -> ModelConfig:
    return ModelConfig(
        swin=swin_large_384(),
        captioner=expansionnet_v2_coco(drop),
        compute_dtype=compute_dtype,
    )


def remove_layers(cfg: ModelConfig, param_config: int) -> ModelConfig:
    """Layer-removal ablations (reference: train.py:374-379).

    param_config: 0 = baseline, 1 = remove one encoder layer, 2 = remove one encoder
    and one decoder layer.
    """
    if param_config == 0:
        return cfg
    cap = cfg.captioner
    if param_config == 1:
        cap = dataclasses.replace(cap, N_enc=cap.N_enc - 1)
    elif param_config == 2:
        cap = dataclasses.replace(cap, N_enc=cap.N_enc - 1, N_dec=cap.N_dec - 1)
    else:
        raise ValueError(f"param_config must be 0/1/2, got {param_config}")
    return dataclasses.replace(cfg, captioner=cap)
