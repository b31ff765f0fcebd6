"""Batched beam search over the incremental decoder, for one model or an
ensemble (counterpart of the JAX package's `decode/beam_search.py`).

Semantics replicate the reference loop (models/captioning_model.py:220-427):

- step 1 seeds beam_size beams from the SOS log-probs (sorted top-k, or,
  with `sample_or_max="sample"`, sampling without replacement as the top-k
  of the log-probs plus Gumbel noise);
- each step proposes beam_size candidates per beam; beams whose prefix holds
  EOS are frozen by zeroing candidate 0 and setting the rest to -999;
- the beam pool is re-ranked by cumulative log-prob over beam_size^2
  candidates;
- `num_elem` counts tokens up to and including the first EOS, and the loop
  stops when no beam grew in the previous step;
- the final ranking divides the cumulative log-prob by the length.

One cache of `max_seq_len` positions is used throughout. The vocab-wide
candidate top-k is kernel K3 (ops/topk.py); the beam-pool and final top-k run
over narrow rows and use the plain, tie-exact version. The early exit syncs
with the host once per step.

Noise. JAX and PyTorch draw different numbers from the same seed, so the
sampling mode takes either a `torch.Generator` on the tensors' device or the
noise itself (`noise`: one (rows, vocab) Gumbel tensor per candidate draw, in
order), which is how a test feeds both packages the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from ..config import CaptionerConfig, DecodeConfig
from ..models.captioner import ExpansionNetV2
from ..ops.topk import topk, topk_reference
from . import cache as dc


@dataclasses.dataclass
class BeamResult:
    tokens: torch.Tensor  # (B, how_many_outputs, L) int32 (garbage after length)
    logprobs: torch.Tensor  # (B, how_many_outputs, L) fp32 per-step log-probs
    lengths: torch.Tensor  # (B, how_many_outputs) int32, SOS and EOS included


def gumbel_source(
    device, generator: Optional[torch.Generator], noise: Optional[Iterable[torch.Tensor]]
) -> Callable[[torch.Size], torch.Tensor]:
    """draw(shape) -> standard Gumbel noise of that shape on `device`: the next
    tensor of `noise` when given, else -log(-log(U)) from `generator` (seed 0
    on `device` when None)."""
    if noise is not None:
        it = iter(noise)

        def draw(shape):
            g = next(it).to(device)
            if g.shape != shape:
                raise ValueError(f"noise of shape {tuple(g.shape)} for a draw of {tuple(shape)}")
            return g

        return draw
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    tiny = torch.finfo(torch.float32).tiny

    def draw(shape):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    return draw


def _candidates(log_probs: torch.Tensor, k: int, draw):
    """Top-k candidates per row, or (draw given) k samples without replacement
    through Gumbel top-k: the indices of the k largest noisy log-probs, with
    the clean log-probs as their values."""
    if draw is None:
        return topk(log_probs, k)
    _, idx = topk(log_probs + draw(log_probs.shape), k)
    return torch.gather(log_probs, 1, idx.long()), idx


@torch.no_grad()
def beam_search(
    model: ExpansionNetV2,
    cfg: CaptionerConfig,
    enc_output: torch.Tensor,
    decode_cfg: DecodeConfig,
    dtype: Optional[torch.dtype] = None,
    enc_num_pads: Optional[torch.Tensor] = None,
    step_impl: str = "pallas",
    generator: Optional[torch.Generator] = None,
    noise: Optional[Iterable[torch.Tensor]] = None,
) -> BeamResult:
    """Single-model beam search. enc_output (B, S_enc, d_model); enc_num_pads
    (B,) trailing pad rows of each. The decoder caches are stored in `dtype`
    (fp32 when None). generator / noise: see the module docstring (used with
    sample_or_max="sample" only)."""
    return ensemble_beam_search(
        [model], cfg, [enc_output], decode_cfg, dtype, enc_num_pads, step_impl, generator, noise)


@torch.no_grad()
def ensemble_beam_search(
    models: Sequence[ExpansionNetV2],
    cfg: CaptionerConfig,
    enc_outputs: Sequence[torch.Tensor],
    decode_cfg: DecodeConfig,
    dtype: Optional[torch.dtype] = None,
    enc_num_pads: Optional[torch.Tensor] = None,
    step_impl: str = "pallas",
    generator: Optional[torch.Generator] = None,
    noise: Optional[Iterable[torch.Tensor]] = None,
) -> BeamResult:
    """Beam search over one decoder state per model: each step's log-probs
    are the log of the mean of the models' probabilities (reference
    models/ensemble_captioning_model.py:55-84). `enc_outputs` holds one
    encoder output per model, each encoded with that model's weights. One
    model is plain beam search."""
    if decode_cfg.sample_or_max not in ("max", "sample"):
        raise ValueError(f"sample_or_max {decode_cfg.sample_or_max!r}")
    k = decode_cfg.beam_size
    L = decode_cfg.max_seq_len
    sos, eos = decode_cfg.sos_idx, decode_cfg.eos_idx
    b = enc_outputs[0].shape[0]
    dev = enc_outputs[0].device
    draw = None
    if decode_cfg.sample_or_max == "sample":
        draw = gumbel_source(dev, generator, noise)
    cache_dtype = dtype if dtype is not None else torch.float32
    states = [
        dc.init_state(m, cfg, e, L, cache_dtype, enc_num_pads)
        for m, e in zip(models, enc_outputs)
    ]

    def step(tokens, pos, reorder=None, group=1):
        logps = []
        for i, m in enumerate(models):
            lp, states[i] = dc.dec_step(
                m, cfg, states[i], tokens, pos, dtype, reorder, group, step_impl)
            logps.append(lp)
        if len(logps) == 1:
            return logps[0]
        return torch.log(torch.exp(torch.stack(logps, dim=0)).mean(dim=0))

    # ---- step 1: expand SOS into beam_size beams ----
    logp0 = step(torch.full((b,), sos, dtype=torch.int32, device=dev), 0)
    first_vals, first_idx = _candidates(logp0, k, draw)  # (B, K)
    tokens = torch.zeros((b, k, L), dtype=torch.int32, device=dev)
    tokens[:, :, 0] = sos
    tokens[:, :, 1] = first_idx
    logprobs = torch.zeros((b, k, L), dtype=torch.float32, device=dev)
    logprobs[:, :, 1] = first_vals.float()
    cumul = first_vals.float()
    num_elem = torch.full((b, k), 2, dtype=torch.int32, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    # the first beam step reads the per-image caches: row (i, j) <- image i
    reorder = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(k)
    img_base = torch.arange(b, dtype=torch.int32, device=dev)[:, None] * k

    t = 2
    while t < L and bool((num_elem == t).any()):
        last = tokens[:, :, t - 1].reshape(b * k)
        logp = step(last, t - 1, reorder, k)
        cand_vals, cand_idx = _candidates(logp, k, draw)
        cand_vals = cand_vals.float().reshape(b, k, k)
        cand_idx = cand_idx.reshape(b, k, k)

        # freeze finished beams
        frozen = finished[:, :, None]
        cand_vals = torch.cat(
            [
                torch.where(frozen, 0.0, cand_vals[:, :, :1]),
                torch.where(frozen, -999.0, cand_vals[:, :, 1:]),
            ],
            dim=-1,
        )
        comparison = (cumul[:, :, None] + cand_vals).reshape(b, k * k)
        top_vals, topi = topk_reference(comparison, k)
        which_seq = (topi // k).long()
        which_word = (topi % k).long()

        tokens = torch.gather(tokens, 1, which_seq[:, :, None].expand(b, k, L))
        logprobs = torch.gather(logprobs, 1, which_seq[:, :, None].expand(b, k, L))
        sel_word = torch.gather(
            torch.gather(cand_idx, 1, which_seq[:, :, None].expand(b, k, k)), 2,
            which_word[:, :, None],
        )[:, :, 0]
        sel_val = torch.gather(
            torch.gather(cand_vals, 1, which_seq[:, :, None].expand(b, k, k)), 2,
            which_word[:, :, None],
        )[:, :, 0]
        tokens[:, :, t] = sel_word
        logprobs[:, :, t] = sel_val

        was_finished = torch.gather(finished, 1, which_seq)
        num_elem = torch.gather(num_elem, 1, which_seq) + (~was_finished).int()
        finished = was_finished | (sel_word == eos)
        cumul = top_vals
        reorder = (img_base + which_seq).reshape(b * k).int()
        t += 1

    # ---- final ranking: length-normalized cumulative log-prob ----
    norm = cumul / num_elem.float()
    _, order = topk_reference(norm, k)
    order = order[:, : decode_cfg.how_many_outputs].long()
    n = order.shape[1]
    return BeamResult(
        tokens=torch.gather(tokens, 1, order[:, :, None].expand(b, n, L)),
        logprobs=torch.gather(logprobs, 1, order[:, :, None].expand(b, n, L)),
        lengths=torch.gather(num_elem, 1, order),
    )


def captions_from_result(res: BeamResult) -> Tuple[List, List]:
    """Host side: truncate the fixed buffers to each caption's length."""
    tokens = res.tokens.cpu().numpy()
    logprobs = res.logprobs.cpu().numpy()
    lengths = res.lengths.cpu().numpy()
    b, n, _ = tokens.shape
    caps = [[tokens[i, j, : lengths[i, j]].tolist() for j in range(n)] for i in range(b)]
    lps = [[logprobs[i, j, : lengths[i, j]].tolist() for j in range(n)] for i in range(b)]
    return caps, lps
