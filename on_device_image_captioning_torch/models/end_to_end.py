"""End-to-end model: Swin backbone + ExpansionNet v2 caption head
(counterpart of the JAX package's `models/end_to_end.py`).

The reference `End_ExpansionNet_v2` keeps the caption head's parameters at
the top level of its state_dict and the backbone under `swin_transf.`, so the
end-to-end module is the caption head with a `swin_transf` attribute.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from .captioner import ExpansionNetV2
from .swin import SwinTransformer


class EndExpansionNetV2(ExpansionNetV2):
    def __init__(self, cfg: ModelConfig, stage_modes: Optional[Dict[int, str]] = None):
        """stage_modes: per-stage override of the "fused" backbone path's
        block kernels (see `SwinTransformer`)."""
        super().__init__(cfg.captioner)
        self.cfg = cfg
        self.swin_transf = SwinTransformer(cfg.swin, stage_modes)

    def prepare_inference(self) -> None:
        """Pre-expand the Swin relative-position biases and lay out the fused
        path's weights in the compute dtype (inference only)."""
        self.swin_transf.prepare_inference(self.cfg.compute_dtype)

    def forward_enc(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images NHWC (B, H, W, 3) -> encoder output
        (B, (H/32)^2, d_model). The end-to-end path has no encoder pads."""
        dtype = self.cfg.compute_dtype
        feats = self.swin_transf(images, dtype)
        return super().forward_enc(feats, None, dtype)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with the JAX package's distributions: trunc-normal(0.02)
    within +-2 std for every >1-dim Swin parameter, xavier-uniform for every
    >1-dim caption-head parameter, zero biases, LayerNorm ones/zeros.
    Parameters are drawn in `named_parameters()` order on the generator's
    device, then copied into place."""
    norms = {
        name for name, mod in model.named_modules() if isinstance(mod, nn.LayerNorm)
    }
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if owner in norms:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif p.dim() < 2:
            p.zero_()
        else:
            t = torch.empty(p.shape, device=generator.device)
            if name.startswith("swin_transf."):
                nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
            else:
                nn.init.xavier_uniform_(t, generator=generator)
            p.copy_(t)
    return model
