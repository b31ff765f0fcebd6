"""Multinomial sampling decode over the incremental decoder (counterpart of
the JAX package's `decode/sampling.py`).

Replicates the reference `get_batch_multiple_sampled_prediction`
(models/captioning_model.py:120-218): each image expands to `num_outputs`
rows, one token is sampled per step from the softmax until every row has
sampled EOS or `max_seq_len` tokens are out, the per-step log-probs are
recorded and zeroed after the first EOS.

The caches grow in phases, as the JAX package's do: `chunks` (the beam
search's `default_chunk_schedule(max_seq_len)` when None) gives the phases;
step t (which writes position t) runs in the phase of the first chunk above
t, on caches of that chunk + 1 positions, zero-padded from the phase before;
the token and log-prob buffers are full length throughout. There is no beam
reshuffle, so every step reads the current cache set through the identity and
writes the spare set (the step kernels never write the set they read). The
encoder side stays one row per image: the `num_outputs` sample rows of an
image share its cross K/V and pad mask through `dec_step`'s `group`.

A token is drawn as the arg-max of the log-probs plus Gumbel noise, which is
how `jax.random.categorical` draws it; the noise comes from a
`torch.Generator` on the tensors' device or is handed in (`noise`: one
(B * num_outputs, vocab) tensor per step), so that a test can feed this
package and the JAX package the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import torch

from ..config import CaptionerConfig
from ..models.captioner import ExpansionNetV2
from . import cache as dc
from .beam_search import check_schedule, chunk_at, default_chunk_schedule, gumbel_source


@dataclasses.dataclass
class SampleResult:
    tokens: torch.Tensor  # (B, num_outputs, L + 1) int32, starts with SOS
    logprobs: torch.Tensor  # (B, num_outputs, L + 1) fp32, 0 after the first EOS
    lengths: torch.Tensor  # (B, num_outputs) int32: index of the first EOS (or L)


@torch.no_grad()
def sample(
    model: ExpansionNetV2,
    cfg: CaptionerConfig,
    enc_output: torch.Tensor,
    num_outputs: int,
    max_seq_len: int,
    sos_idx: int,
    eos_idx: int,
    dtype: Optional[torch.dtype] = None,
    enc_num_pads: Optional[torch.Tensor] = None,
    step_impl: str = "pallas",
    generator: Optional[torch.Generator] = None,
    noise: Optional[Iterable[torch.Tensor]] = None,
    chunks: Optional[Sequence[int]] = None,
) -> SampleResult:
    """enc_output (B, S_enc, d_model); enc_num_pads (B,) trailing pad rows of
    each. The decoder caches are stored in `dtype` (fp32 when None). chunks:
    the cache-length schedule (module docstring), strictly increasing to
    max_seq_len; ValueError otherwise."""
    b = enc_output.shape[0]
    dev = enc_output.device
    n = b * num_outputs
    L = max_seq_len
    chunks = check_schedule(default_chunk_schedule(L) if chunks is None else chunks, L,
                            even=False)
    draw = gumbel_source(dev, generator, noise)
    cache_dtype = dtype if dtype is not None else torch.float32
    state = dc.init_state(model, cfg, enc_output, chunks[0] + 1, cache_dtype, enc_num_pads)

    tokens = torch.zeros((n, L + 1), dtype=torch.int32, device=dev)
    tokens[:, 0] = sos_idx
    logprobs = torch.zeros((n, L + 1), dtype=torch.float32, device=dev)
    where_eos = torch.full((n,), L, dtype=torch.int32, device=dev)
    finished = torch.zeros((n,), dtype=torch.bool, device=dev)
    # the first step reads the per-image caches: row (i, j) <- image i
    reorder = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(num_outputs)
    identity = torch.arange(n, dtype=torch.int32, device=dev)

    t = 0
    while t < L and not bool(finished.all()):
        state = dc.grow_state(state, chunk_at(chunks, t) + 1)
        logp, state = dc.dec_step(
            model, cfg, state, tokens[:, t], t, dtype, reorder, num_outputs, step_impl)
        reorder = identity
        word = torch.argmax(logp + draw(logp.shape), dim=-1)
        tokens[:, t + 1] = word.int()
        logprobs[:, t + 1] = torch.gather(logp, 1, word[:, None])[:, 0]
        is_eos = word == eos_idx
        where_eos = torch.minimum(where_eos, torch.where(is_eos, t + 1, L).int())
        finished = finished | is_eos
        t += 1

    after_eos = torch.arange(L + 1, device=dev)[None, :] > where_eos[:, None]
    logprobs = torch.where(after_eos, 0.0, logprobs)
    return SampleResult(
        tokens=tokens.reshape(b, num_outputs, L + 1),
        logprobs=logprobs.reshape(b, num_outputs, L + 1),
        lengths=where_eos.reshape(b, num_outputs),
    )


def captions_from_result(res: SampleResult) -> List[List[List[int]]]:
    """Host side: token lists truncated after the first EOS."""
    tokens = res.tokens.cpu().numpy()
    lengths = res.lengths.cpu().numpy()
    b, n, _ = tokens.shape
    return [[tokens[i, j, : lengths[i, j] + 1].tolist() for j in range(n)] for i in range(b)]
