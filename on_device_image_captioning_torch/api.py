"""High-level captioning API, beam mode (counterpart of the JAX package's
`api.Captioner`).

`Captioner` wraps one end-to-end model (`EndExpansionNetV2`, images in),
moves it to its `device` (the card unless the caller asks for the CPU) and
runs there. The features-in form, sampling and ensembles are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import DecodeConfig, ModelConfig
from .decode import beam_search as bs
from .models.end_to_end import EndExpansionNetV2
from .utils.image import normalize_on_device


class Captioner:
    """beam_search_args mirrors the reference dict: sos_idx, eos_idx,
    beam_size, how_many_outputs, beam_max_seq_len
    (reference models/captioning_model.py:67-110). The backbone path is
    `cfg.swin.attention_impl`."""

    def __init__(
        self,
        model: EndExpansionNetV2,
        cfg: ModelConfig,
        beam_search_args: Optional[dict] = None,
        device="cuda",
    ):
        if not (isinstance(model, EndExpansionNetV2) and isinstance(cfg, ModelConfig)):
            raise ValueError("Captioner takes an EndExpansionNetV2 and its ModelConfig")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Captioner runs on a CUDA card and none is available; "
                'pass device="cpu" to run on the CPU'
            )
        model.to(self.device).eval()
        model.prepare_inference()
        self.model = model
        self.cfg = cfg
        self.cap_cfg = cfg.captioner
        self.dtype = cfg.compute_dtype
        self.beam_search_args = dict(beam_search_args or {})
        self.beam_search_args.setdefault("sos_idx", self.cap_cfg.sos_idx)
        self.beam_search_args.setdefault("eos_idx", self.cap_cfg.eos_idx)

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device)

    @torch.inference_mode()
    def forward_enc(self, images) -> torch.Tensor:
        """Images NHWC, uint8 (normalized here, on the device) or already
        normalized float -> encoder output (B, S_enc, d_model)."""
        x = self._to_device(images)
        if x.dtype == torch.uint8:
            x = normalize_on_device(x)
        return self.model.forward_enc(x)

    def __call__(self, enc_x, mode: str = "beam_search"):
        if mode == "beam_search":
            return self.beam_search(enc_x)
        raise ValueError(f"mode {mode!r} is not ported (beam_search only)")

    def decode_config(self) -> DecodeConfig:
        a = self.beam_search_args
        return DecodeConfig(
            beam_size=a.get("beam_size", 5),
            how_many_outputs=a.get("how_many_outputs", 1),
            max_seq_len=a.get("beam_max_seq_len", 20),
            sample_or_max=a.get("sample_or_max", "max"),
            sos_idx=a["sos_idx"], eos_idx=a["eos_idx"],
        )

    @torch.inference_mode()
    def decode(self, cross: torch.Tensor) -> bs.BeamResult:
        """Beam search over an encoder output (B, S_enc, d_model), on the
        device; the result stays there."""
        return bs.beam_search(self.model, self.cap_cfg, cross, self.decode_config(),
                              dtype=self.dtype)

    @torch.inference_mode()
    def beam_search(self, enc_x) -> Tuple[List[List[List[int]]], List]:
        """Returns (captions, per-token log-probs): one list per image of
        how_many_outputs token lists, SOS and EOS included."""
        return bs.captions_from_result(self.decode(self.forward_enc(enc_x)))
