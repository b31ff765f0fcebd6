"""High-level captioning API (counterpart of the JAX package's
`api.Captioner` and `api.EnsembleCaptioner`).

`Captioner` wraps one model, moves it to its `device` (the card unless the
caller asks for the CPU) and runs there. The model is either end-to-end
(`EndExpansionNetV2` with a `ModelConfig`: images in) or the caption head
alone (`ExpansionNetV2` with a `CaptionerConfig`: visual features in, padded
batches described by `enc_x_num_pads`). Modes: the teacher-forced forward,
beam search (with `sample_or_max="sample"` too) and multinomial sampling.
`step_impl` picks the decode-step path (`decode/cache.py`): "pallas" or
"pallas_fused". `EnsembleCaptioner` decodes several models' averaged probabilities.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import CaptionerConfig, DecodeConfig, ModelConfig
from .decode import beam_search as bs
from .decode import cache as dc
from .decode import sampling as smp
from .models.captioner import ExpansionNetV2
from .models.end_to_end import EndExpansionNetV2
from .utils.image import normalize_on_device
from .utils.profiling import span


def _decode_config(a: dict) -> DecodeConfig:
    return DecodeConfig(
        beam_size=a.get("beam_size", 5),
        how_many_outputs=a.get("how_many_outputs", 1),
        max_seq_len=a.get("beam_max_seq_len", 20),
        sample_or_max=a.get("sample_or_max", "max"),
        sos_idx=a["sos_idx"], eos_idx=a["eos_idx"],
    )


class Captioner:
    """beam_search_args mirrors the reference dict: sos_idx, eos_idx,
    beam_size, how_many_outputs, beam_max_seq_len / sample_max_seq_len,
    sample_or_max (reference models/captioning_model.py:67-110). The backbone
    path of an end-to-end model is `cfg.swin.attention_impl`."""

    def __init__(
        self,
        model: ExpansionNetV2,
        cfg: Union[ModelConfig, CaptionerConfig],
        beam_search_args: Optional[dict] = None,
        device="cuda",
        step_impl: str = "pallas",
    ):
        self.end_to_end = isinstance(cfg, ModelConfig)
        if self.end_to_end != isinstance(model, EndExpansionNetV2) or not isinstance(
                model, ExpansionNetV2) or not isinstance(cfg, (ModelConfig, CaptionerConfig)):
            raise ValueError(
                "Captioner takes an EndExpansionNetV2 with its ModelConfig or an "
                "ExpansionNetV2 with its CaptionerConfig")
        if step_impl not in dc.STEP_IMPLS:
            raise ValueError(f"step_impl {step_impl!r}; expected one of {dc.STEP_IMPLS}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Captioner runs on a CUDA card and none is available; "
                'pass device="cpu" to run on the CPU'
            )
        model.to(self.device).eval()
        if self.end_to_end:
            model.prepare_inference()
        self.model = model
        self.cfg = cfg
        self.cap_cfg = cfg.captioner if self.end_to_end else cfg
        # the features-in form computes in fp32, as the JAX package's does
        self.dtype = cfg.compute_dtype if self.end_to_end else None
        self.step_impl = step_impl
        self.beam_search_args = dict(beam_search_args or {})
        self.beam_search_args.setdefault("sos_idx", self.cap_cfg.sos_idx)
        self.beam_search_args.setdefault("eos_idx", self.cap_cfg.eos_idx)

    def _to_device(self, x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        elif not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        return x.to(self.device)

    @torch.inference_mode()
    def forward_enc(self, enc_input, enc_num_pads=None) -> torch.Tensor:
        """End-to-end: images NHWC, uint8 (normalized here, on the device) or
        already normalized float. Features-in: (B, S, img_feature_dim)
        features with enc_num_pads (B,) trailing pad rows. Returns the encoder
        output (B, S_enc, d_model). Recorded as the span `encode`."""
        with span("encode"):
            x = self._to_device(enc_input)
            if self.end_to_end:
                if x.dtype == torch.uint8:
                    x = normalize_on_device(x)
                return self.model.forward_enc(x)
            return self.model.forward_enc(x.float(), self._to_device(enc_num_pads))

    @torch.inference_mode()
    def forward_dec(self, cross_input, dec_input, dec_num_pads=None,
                    apply_log_softmax: bool = False) -> torch.Tensor:
        """The decoder over a full token prefix: encoder output (B, S_enc,
        d_model), dec_input (B, T) ids and dec_num_pads (B,) trailing pad
        tokens -> logits (B, T, vocab), log-softmaxed in fp32 when
        apply_log_softmax. No encoder pads reach the decoder (the end-to-end
        model has none), as in the JAX package's `forward_dec`."""
        return self.model.forward_dec(
            self._to_device(cross_input), self._to_device(dec_input),
            self._to_device(dec_num_pads), None, apply_log_softmax, self.dtype)

    def __call__(self, enc_x, dec_x=None, enc_x_num_pads=None, dec_x_num_pads=None,
                 mode: str = "beam_search", generator: Optional[torch.Generator] = None,
                 noise: Optional[Iterable[torch.Tensor]] = None):
        """The JAX package's call: mode "forward" (teacher-forced log-probs of
        the prefix dec_x), "beam_search" or "sampling"; generator / noise take
        the place of its rng."""
        if mode == "forward":
            cross = self.forward_enc(enc_x, enc_x_num_pads)
            return self.forward_dec(cross, dec_x, dec_x_num_pads, apply_log_softmax=True)
        if mode == "beam_search":
            return self.beam_search(enc_x, enc_x_num_pads, generator, noise)
        if mode == "sampling":
            return self.sample(enc_x, enc_x_num_pads, generator, noise)
        raise ValueError(f"unknown mode {mode!r} (forward, beam_search or sampling)")

    def decode_config(self) -> DecodeConfig:
        return _decode_config(self.beam_search_args)

    @torch.inference_mode()
    def decode(self, cross: torch.Tensor, enc_num_pads=None, generator=None,
               noise=None) -> bs.BeamResult:
        """Beam search over an encoder output (B, S_enc, d_model), on the
        device; the result stays there."""
        return bs.beam_search(
            self.model, self.cap_cfg, cross, self.decode_config(), dtype=self.dtype,
            enc_num_pads=self._to_device(enc_num_pads), step_impl=self.step_impl,
            generator=generator, noise=noise)

    @torch.inference_mode()
    def beam_search(self, enc_x, enc_x_num_pads=None, generator=None, noise=None
                    ) -> Tuple[List[List[List[int]]], List]:
        """Returns (captions, per-token log-probs): one list per image of
        how_many_outputs token lists, SOS and EOS included. generator / noise
        feed sample_or_max="sample" (`decode/beam_search.py`)."""
        cross = self.forward_enc(enc_x, enc_x_num_pads)
        return bs.captions_from_result(self.decode(cross, enc_x_num_pads, generator, noise))

    @torch.inference_mode()
    def sample_result(self, cross: torch.Tensor, enc_num_pads=None, generator=None,
                      noise=None) -> smp.SampleResult:
        """Multinomial sampling over an encoder output, on the device."""
        a = self.beam_search_args
        return smp.sample(
            self.model, self.cap_cfg, cross, a.get("how_many_outputs", 1),
            a.get("sample_max_seq_len", 20), a["sos_idx"], a["eos_idx"], dtype=self.dtype,
            enc_num_pads=self._to_device(enc_num_pads), step_impl=self.step_impl,
            generator=generator, noise=noise)

    @torch.inference_mode()
    def sample(self, enc_x, enc_x_num_pads=None, generator=None, noise=None):
        """how_many_outputs sampled captions per image, up to
        sample_max_seq_len tokens. Returns (captions, log-probs (B, n, L + 1)
        zeroed after the first EOS)."""
        res = self.sample_result(
            self.forward_enc(enc_x, enc_x_num_pads), enc_x_num_pads, generator, noise)
        return smp.captions_from_result(res), res.logprobs


class EnsembleCaptioner:
    """Beam decoding over several checkpoints (reference
    models/ensemble_captioning_model.py:6-291): each model encodes with its
    own weights; the step probabilities are averaged. The caches are fp32, as
    in the JAX package's ensemble."""

    def __init__(self, captioners: Sequence[Captioner], beam_search_args=None):
        if not captioners:
            raise ValueError("need at least one model")
        self.captioners = list(captioners)
        self.cap_cfg = captioners[0].cap_cfg
        self.step_impl = captioners[0].step_impl
        self.beam_search_args = dict(beam_search_args or captioners[0].beam_search_args)

    @torch.inference_mode()
    def decode(self, encs: Sequence[torch.Tensor], enc_num_pads=None, generator=None,
               noise=None) -> bs.BeamResult:
        first = self.captioners[0]
        return bs.ensemble_beam_search(
            [c.model for c in self.captioners], self.cap_cfg, [e.float() for e in encs],
            _decode_config(self.beam_search_args), dtype=None,
            enc_num_pads=first._to_device(enc_num_pads), step_impl=self.step_impl,
            generator=generator, noise=noise)

    def __call__(self, enc_x, enc_x_num_pads=None, mode: str = "beam_search",
                 generator=None, noise=None):
        if mode != "beam_search":
            raise ValueError("an ensemble supports only beam search")
        encs = [c.forward_enc(enc_x, enc_x_num_pads) for c in self.captioners]
        return bs.captions_from_result(self.decode(encs, enc_x_num_pads, generator, noise))
