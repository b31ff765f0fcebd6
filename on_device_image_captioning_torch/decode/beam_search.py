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

Chunked decode, as in the JAX package: the caches start at the first chunk
of `DecodeConfig.chunk_schedule` (`default_chunk_schedule` when None) and
are zero-padded on their position axis to the next chunk once the step to
run no longer fits (`decode/cache.py::grow_state`). The decode-step kernels
read and write every position of the caches they are given, so early steps
on short caches move fewer bytes; positions after `pos` are masked, so the
tokens equal a single phase's. The vocab-wide
candidate top-k is kernel K3 (ops/topk.py); the beam-pool and final top-k run
over narrow rows and use the plain, tie-exact version, whose NaN rule runs on
the device. A step (`_beam_step`) does not sync with the host; two loops
run it: `ensemble_beam_search` with the early exit, which syncs with the host
once per step and grows the caches only while some beam still grows, and
`fixed_beam_search` for a fixed number of steps, growing at every chunk
boundary, the form `torch.export` traces (`deploy/aot.py`). On the card the
early-exit loop replays its steps from CUDA graphs, one graph a step
(`decode/graphs.py`, `_graphed_beam_search`), and runs them eagerly
everywhere else (`_eager_beam_search`).

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
from ..utils.profiling import span
from . import cache as dc
from . import graphs


@dataclasses.dataclass
class BeamResult:
    tokens: torch.Tensor  # (B, how_many_outputs, L) int32 (garbage after length)
    logprobs: torch.Tensor  # (B, how_many_outputs, L) fp32 per-step log-probs
    lengths: torch.Tensor  # (B, how_many_outputs) int32, SOS and EOS included


def default_chunk_schedule(max_seq_len: int, first: int = 12) -> Tuple[int, ...]:
    """The JAX package's cache-length schedule, number for number: one phase
    for a budget up to first + 4, (first, L) up to first + 8, else a ramp of
    first, 2 x first while under 24, then +16 a phase, every chunk but the
    last even (first is rounded up to even), and a chunk within 8 of
    max_seq_len merged into the last phase."""
    first = first + (first % 2)
    if max_seq_len <= first + 4:
        return (max_seq_len,)
    if max_seq_len <= first + 8:
        return (first, max_seq_len)
    chunks = []
    c = first
    while c + 8 < max_seq_len:
        chunks.append(c + (c % 2))
        c = 2 * c if c < 24 else c + 16
    chunks.append(max_seq_len)
    return tuple(chunks)


def check_schedule(chunks: Sequence[int], max_seq_len: int, even: bool = True
                   ) -> Tuple[int, ...]:
    """`chunks` as a tuple, or ValueError where the JAX package's loops refuse
    it: not strictly increasing, or not ending at max_seq_len, or (even=True,
    the beam loop's rule) a chunk but the last that is odd. Also refused,
    where the JAX package would run it: a first chunk below 1."""
    chunks = tuple(chunks)
    if not chunks or chunks[-1] != max_seq_len or chunks != tuple(sorted(set(chunks))):
        raise ValueError(
            f"chunk schedule {chunks} must increase strictly to max_seq_len={max_seq_len}")
    if chunks[0] < 1:
        raise ValueError(f"chunk schedule {chunks}: the first chunk holds no position")
    if even and any(c % 2 for c in chunks[:-1]):
        raise ValueError(f"chunk schedule {chunks}: every chunk but the last must be even")
    return chunks


def schedule_of(decode_cfg: DecodeConfig) -> Tuple[int, ...]:
    """The beam loops' checked schedule: decode_cfg.chunk_schedule, or the
    default for its max_seq_len where that is None (or empty, as in the JAX
    package)."""
    L = decode_cfg.max_seq_len
    return check_schedule(decode_cfg.chunk_schedule or default_chunk_schedule(L), L)


def chunk_at(chunks: Tuple[int, ...], t: int) -> int:
    """The chunk whose phase runs step t: the first chunk above t (a beam
    step t writes position t - 1; a sampling step t writes position t into
    caches of chunk + 1)."""
    return next(c for c in chunks if t < c)


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


@dataclasses.dataclass
class _Beams:
    """The beams between two steps: everything `_beam_step` reads and writes."""
    tokens: torch.Tensor  # (B, K, L) int32
    logprobs: torch.Tensor  # (B, K, L) fp32
    cumul: torch.Tensor  # (B, K) fp32 cumulative log-probs
    num_elem: torch.Tensor  # (B, K) int32 tokens up to and including the first EOS
    finished: torch.Tensor  # (B, K) bool: the prefix holds EOS
    reorder: torch.Tensor  # (B * K,) int32: the cache row each beam continues
    img_base: torch.Tensor  # (B, 1) int32: the first beam row of each image


def _start(models, cfg, enc_outputs, decode_cfg, dtype, enc_num_pads, step_impl, generator,
           noise, dec_step=dc.dec_step):
    """The decoder states, at the schedule's first chunk, and step 1, which
    expands SOS into beam_size beams. Returns (step, grow, chunks, draw,
    beams): step(tokens, pos, reorder, group) -> the models' log-probs of the
    next token through `dec_step`; grow(length) zero-pads every model's
    caches to that length; chunks the checked schedule; draw the noise source
    (None for "max"); states the list of the models' decoder states that
    step and grow replace."""
    if decode_cfg.sample_or_max not in ("max", "sample"):
        raise ValueError(f"sample_or_max {decode_cfg.sample_or_max!r}")
    k = decode_cfg.beam_size
    L = decode_cfg.max_seq_len
    b = enc_outputs[0].shape[0]
    dev = enc_outputs[0].device
    draw = None
    if decode_cfg.sample_or_max == "sample":
        draw = gumbel_source(dev, generator, noise)
    cache_dtype = dtype if dtype is not None else torch.float32
    chunks = schedule_of(decode_cfg)
    states = [
        dc.init_state(m, cfg, e, chunks[0], cache_dtype, enc_num_pads)
        for m, e in zip(models, enc_outputs)
    ]

    def grow(length):
        states[:] = [dc.grow_state(st, length) for st in states]

    def step(tokens, pos, reorder=None, group=1):
        logps = []
        for i, m in enumerate(models):
            lp, states[i] = dec_step(
                m, cfg, states[i], tokens, pos, dtype, reorder, group, step_impl)
            logps.append(lp)
        if len(logps) == 1:
            return logps[0]
        return torch.log(torch.exp(torch.stack(logps, dim=0)).mean(dim=0))

    logp0 = step(torch.full((b,), decode_cfg.sos_idx, dtype=torch.int32, device=dev), 0)
    first_vals, first_idx = _candidates(logp0, k, draw)  # (B, K)
    tokens = torch.zeros((b, k, L), dtype=torch.int32, device=dev)
    tokens[:, :, 0] = decode_cfg.sos_idx
    tokens[:, :, 1] = first_idx
    logprobs = torch.zeros((b, k, L), dtype=torch.float32, device=dev)
    logprobs[:, :, 1] = first_vals.float()
    beams = _Beams(
        tokens=tokens, logprobs=logprobs, cumul=first_vals.float(),
        num_elem=torch.full((b, k), 2, dtype=torch.int32, device=dev),
        finished=torch.zeros((b, k), dtype=torch.bool, device=dev),
        # the first beam step reads the per-image caches: row (i, j) <- image i
        reorder=torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(k),
        img_base=torch.arange(b, dtype=torch.int32, device=dev)[:, None] * k,
    )
    return step, grow, chunks, draw, beams, states


def _beam_step(step, beams: _Beams, t: int, eos: int, draw) -> _Beams:
    """Beam step t: candidates of every beam, the frozen ones for finished
    beams, the beam pool re-ranked, the picks written at position t. No sync
    with the host. Once every beam is finished a step is the identity on the
    beams: the frozen candidates are 0 and -999, `cumul` is already sorted
    (so every beam picks itself), and neither `num_elem` nor `cumul` moves."""
    b, k, L = beams.tokens.shape
    last = beams.tokens[:, :, t - 1].reshape(b * k)
    logp = step(last, t - 1, beams.reorder, k)
    cand_vals, cand_idx = _candidates(logp, k, draw)
    cand_vals = cand_vals.float().reshape(b, k, k)
    cand_idx = cand_idx.reshape(b, k, k)

    # freeze finished beams
    frozen = beams.finished[:, :, None]
    cand_vals = torch.cat(
        [
            torch.where(frozen, 0.0, cand_vals[:, :, :1]),
            torch.where(frozen, -999.0, cand_vals[:, :, 1:]),
        ],
        dim=-1,
    )
    comparison = (beams.cumul[:, :, None] + cand_vals).reshape(b, k * k)
    top_vals, topi = topk_reference(comparison, k)
    which_seq = (topi // k).long()
    which_word = (topi % k).long()

    tokens = torch.gather(beams.tokens, 1, which_seq[:, :, None].expand(b, k, L))
    logprobs = torch.gather(beams.logprobs, 1, which_seq[:, :, None].expand(b, k, L))
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

    was_finished = torch.gather(beams.finished, 1, which_seq)
    return _Beams(
        tokens=tokens, logprobs=logprobs, cumul=top_vals,
        num_elem=torch.gather(beams.num_elem, 1, which_seq) + (~was_finished).int(),
        finished=was_finished | (sel_word == eos),
        reorder=(beams.img_base + which_seq).reshape(b * k).int(),
        img_base=beams.img_base,
    )


def _ranked(beams: _Beams, how_many_outputs: int) -> BeamResult:
    """The final ranking: length-normalized cumulative log-prob, best first."""
    b, k, L = beams.tokens.shape
    norm = beams.cumul / beams.num_elem.float()
    _, order = topk_reference(norm, k)
    order = order[:, :how_many_outputs].long()
    n = order.shape[1]
    return BeamResult(
        tokens=torch.gather(beams.tokens, 1, order[:, :, None].expand(b, n, L)),
        logprobs=torch.gather(beams.logprobs, 1, order[:, :, None].expand(b, n, L)),
        lengths=torch.gather(beams.num_elem, 1, order),
    )


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
    model is plain beam search. The loop stops when no beam grew in the
    previous step: the one sync with the host a step. The caches grow to the
    next chunk only when a step that runs needs it. On the card the steps
    are replayed from CUDA graphs where `decode/graphs.py::engages` says so
    (the same kernels on the same operands: the same result). Recorded as
    the spans `decode`, `decode.start`, `decode.sync` and `decode.step`
    (`utils/profiling.py`)."""
    with span("decode"):
        if graphs.engages(models, enc_outputs, decode_cfg, generator, noise):
            return _graphed_beam_search(models, cfg, enc_outputs, decode_cfg, dtype,
                                        enc_num_pads, step_impl)
        return _eager_beam_search(models, cfg, enc_outputs, decode_cfg, dtype, enc_num_pads,
                                  step_impl, generator, noise)


def _eager_beam_search(models, cfg, enc_outputs, decode_cfg, dtype=None, enc_num_pads=None,
                       step_impl="pallas", generator=None, noise=None) -> BeamResult:
    """The early-exit loop, launch by launch (`ensemble_beam_search`'s
    arguments)."""
    with span("decode.start"):
        step, grow, chunks, draw, beams, _ = _start(models, cfg, enc_outputs, decode_cfg, dtype,
                                                    enc_num_pads, step_impl, generator, noise)
    t = 2
    while t < decode_cfg.max_seq_len:
        with span("decode.sync", t=t):
            grows = bool((beams.num_elem == t).any())
        if not grows:
            break
        with span("decode.step", t=t):
            grow(chunk_at(chunks, t))
            beams = _beam_step(step, beams, t, decode_cfg.eos_idx, draw)
        t += 1
    return _ranked(beams, decode_cfg.how_many_outputs)


_GRAPHS = graphs.DecodeCache()  # the process's graphed decodes


@dataclasses.dataclass
class _CapturedDecode:
    """One key's graphs: the start (decoder states and step 1), one a step
    t = 2 ... L-1, and the ranking; with their inputs and outputs."""
    enc: List[torch.Tensor]  # the start's inputs: the encoder outputs
    pads: Optional[torch.Tensor]  # and the encoder pads, where there are any
    steps: List  # the start's graph, then step t's at index t - 1
    beams: List[_Beams]  # the beams each of `steps` leaves
    ranked: object  # the ranking's graph, which reads beams[-1]
    result: BeamResult  # what it leaves
    held: tuple  # the decoder states, workspaces, layouts and weights the graphs read


def _graphed_beam_search(models, cfg, enc_outputs, decode_cfg, dtype=None, enc_num_pads=None,
                         step_impl="pallas", cache=None, graphs_for=None) -> BeamResult:
    """The early-exit loop replayed from graphs: the first call of a key
    warms up eagerly, the second captures (`_capture_decode`), and from then
    on `_replay_decode`. `cache` (default: the process's) keeps the keys;
    `graphs_for(device)` makes a decode's graphs (default
    `graphs.cuda_graphs`; `graphs.host_graphs` on the CPU)."""
    cache = _GRAPHS if cache is None else cache
    graphs_for = graphs.cuda_graphs if graphs_for is None else graphs_for
    key = graphs.decode_key(models, enc_outputs, decode_cfg, schedule_of(decode_cfg), dtype,
                            enc_num_pads, step_impl)
    entry = cache.lookup(key, models)
    if entry is None:
        result = _eager_beam_search(models, cfg, enc_outputs, decode_cfg, dtype, enc_num_pads,
                                    step_impl)
        cache.warmed(key, models)
        return result
    if entry.decode is None:
        entry.decode = _capture_decode(models, cfg, enc_outputs, decode_cfg, dtype,
                                       enc_num_pads, step_impl, graphs_for)
        if entry.decode is None:  # it had to size or lay out: eager once more
            return _eager_beam_search(models, cfg, enc_outputs, decode_cfg, dtype,
                                      enc_num_pads, step_impl)
    return _replay_decode(entry.decode, enc_outputs, enc_num_pads, decode_cfg.max_seq_len)


def _capture_decode(models, cfg, enc_outputs, decode_cfg, dtype, enc_num_pads, step_impl,
                    graphs_for) -> Optional[_CapturedDecode]:
    """Capture the start, every step t = 2 ... L-1 (its cache growth
    included) and the ranking, in order, each reading the outputs of the one
    before; None where the capture sized a workspace or laid out an operand
    (nothing is then kept)."""
    dev = enc_outputs[0].device
    L, eos = decode_cfg.max_seq_len, decode_cfg.eos_idx
    enc = [e.clone() for e in enc_outputs]
    pads = None if enc_num_pads is None else enc_num_pads.to(dev).clone()
    lazy = graphs.lazy_state(models, dev)
    new_graph = graphs_for(dev)
    loop = {}

    def start():
        step, grow, chunks, _, beams, states = _start(models, cfg, enc, decode_cfg, dtype, pads,
                                                      step_impl, None, None)
        loop.setdefault("fns", (step, grow, chunks, states))  # the captured run's
        return list(states), beams

    steps, outs = [new_graph()], []
    try:
        outs.append(steps[0].capture(start))
        step, grow, chunks, states = loop["fns"]
        for t in range(2, L):
            def run(t=t, states_in=outs[-1][0], beams_in=outs[-1][1]):
                states[:] = states_in
                grow(chunk_at(chunks, t))
                beams = _beam_step(step, beams_in, t, eos, None)
                return list(states), beams

            steps.append(new_graph())
            outs.append(steps[-1].capture(run))
        beams = [b for _, b in outs]
        ranked = new_graph()
        result = ranked.capture(lambda: _ranked(beams[-1], decode_cfg.how_many_outputs))
    finally:
        moved = not graphs.same_lazy_state(lazy, graphs.lazy_state(models, dev))
        if moved:
            graphs.restore_lazy_state(models, dev, lazy)
    if moved:
        return None
    held = ([s for s, _ in outs], lazy, [graphs.decoder_tensors(m) for m in models])
    return _CapturedDecode(enc, pads, steps, beams, ranked, result, held)


def _replay_decode(dec: _CapturedDecode, enc_outputs, enc_num_pads, L: int) -> BeamResult:
    """The early-exit loop over the captured steps: the same exit test
    before each step, the same steps, and the ranking of the last beams that
    ran. Returns copies: a later replay leaves them as they are."""
    with span("decode.start"):
        for static, e in zip(dec.enc, enc_outputs):
            static.copy_(e)
        if dec.pads is not None:
            dec.pads.copy_(enc_num_pads)
        dec.steps[0].replay()
    t = 2
    while t < L:
        with span("decode.sync", t=t):
            grows = bool((dec.beams[t - 2].num_elem == t).any())
        if not grows:
            break
        with span("decode.step", t=t):
            dec.steps[t - 1].replay()
        t += 1
    if t < L:  # the loop stopped after step t - 1: the ranking reads its beams
        final, last = dec.beams[t - 2], dec.beams[-1]
        for name in ("tokens", "logprobs", "cumul", "num_elem"):
            getattr(last, name).copy_(getattr(final, name))
    dec.ranked.replay()
    r = dec.result
    return BeamResult(tokens=r.tokens.clone(), logprobs=r.logprobs.clone(),
                      lengths=r.lengths.clone())


def fixed_beam_search(
    model: ExpansionNetV2,
    cfg: CaptionerConfig,
    enc_output: torch.Tensor,
    decode_cfg: DecodeConfig,
    dtype: Optional[torch.dtype] = None,
    step_impl: str = "pallas",
) -> BeamResult:
    """Beam search with a fixed number of steps: `_beam_step` for t = 2 ...
    L-1 with no exit test, the caches grown at every boundary of the chunk
    schedule (the JAX engine runs the same schedule), so that the whole
    decode is one traceable graph (`deploy/aot.py`; the reference's unrolled
    decoder, with beams). The steps after every beam finished are the
    identity on the beams, so
    captions (tokens up to `lengths`), lengths and log-probs up to the length
    equal `beam_search`'s; tokens past a caption's length are not part of the
    result in either. Runs under the caller's grad mode (no switch inside:
    it would split a traced graph)."""
    step, grow, chunks, draw, beams, _ = _start([model], cfg, [enc_output], decode_cfg, dtype,
                                                None, step_impl, None, None,
                                                dc.dec_step_unguarded)
    for t in range(2, decode_cfg.max_seq_len):
        grow(chunk_at(chunks, t))
        beams = _beam_step(step, beams, t, decode_cfg.eos_idx, draw)
    return _ranked(beams, decode_cfg.how_many_outputs)


def captions_from_result(res: BeamResult) -> Tuple[List, List]:
    """Host side: truncate the fixed buffers to each caption's length."""
    with span("captions"):
        tokens = res.tokens.cpu().numpy()
        logprobs = res.logprobs.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        b, n, _ = tokens.shape
        caps = [[tokens[i, j, : lengths[i, j]].tolist() for j in range(n)] for i in range(b)]
        lps = [[logprobs[i, j, : lengths[i, j]].tolist() for j in range(n)] for i in range(b)]
    return caps, lps
