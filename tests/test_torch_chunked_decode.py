"""Chunked decode (`DecodeConfig.chunk_schedule`) in the port against the JAX
package on the CPU.

- `default_chunk_schedule` number for number, and the schedules the JAX
  loops refuse refused here too (hypothesis over short tuples);
- beam search, the two-model ensemble, sampled beams (`sample_or_max=
  "sample"`) and sampling at the same chunks as the JAX functions, fp32, the
  Gumbel noise drawn from the JAX key chain where noise enters: tokens and
  lengths equal, log-probs within 1e-5 absolute (fp32 through a 2 + 2 layer
  d32 captioner; the two packages sum in other orders);
- in the port: chunked equals one phase (tokens exactly, log-probs within
  1e-5), `fixed_beam_search` equals the early-exit loop under one schedule
  (bit for bit up to each caption's length), a decoder state grown between
  phases (`decode/cache.py::grow_state`) never hands the step a spare cache
  set of the old length, the exported engine and the SCST sampler follow the
  schedule, a w8a8 caption head and a model group of two gloo ranks
  (`tests/_torch_chunked_tp_worker.py`) decode in phases too;
- the decode-step kernels' launch plan (`ops/dyn_exp_step.py::step_plan`) at
  every cache length the default schedules give the serve, latency and SCST
  cells.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from on_device_image_captioning_torch.api import Captioner
from on_device_image_captioning_torch.config import DecodeConfig as PDecodeConfig
from on_device_image_captioning_torch.decode import beam_search as pbs
from on_device_image_captioning_torch.decode import cache as pdc
from on_device_image_captioning_torch.decode import sampling as psmp
from on_device_image_captioning_torch.deploy import aot
from on_device_image_captioning_torch.ops import dyn_exp_step as pk2
from on_device_image_captioning_torch.train import radam as pradam
from on_device_image_captioning_torch.train import train_step as pstep
from on_device_image_captioning_tpu import api as japi
from on_device_image_captioning_tpu.config import DecodeConfig as JDecodeConfig
from on_device_image_captioning_tpu.decode import beam_search as jbs
from on_device_image_captioning_tpu.decode import cache as jdc
from on_device_image_captioning_tpu.decode import sampling as jsmp
from on_device_image_captioning_tpu.deploy import aot as jaot
from on_device_image_captioning_tpu.models import captioner as jcap

from test_torch_harness import (
    TINY_CAP, TINY_E2E, captioner_pair, e2e_pair, to_jax_cap, to_jax_model,
)

LP_TOL = 1e-5  # log-probs, fp32 against the JAX package
L_BEAM, BEAM = 17, 3
L_SAMPLE, N_SAMPLES = 18, 3
# per seed, an EOS id these weights emit: (0, 14) ends captions at 7, 10, 11
# and 17 (every phase of (6, 10, 17) runs); (1, 43) ends every beam by 12
# (the loop stops inside the last phase)
EOS_CASES = [(0, 14), (1, 43)]


def _features(seed, b=2, s=7):
    return np.random.default_rng(seed).standard_normal(
        (b, s, TINY_CAP.img_feature_dim)).astype(np.float32)


def _gumbel_chain(key, shapes):
    """The Gumbel noise the JAX decode loops draw: one `split` per draw."""
    out = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, shape, jnp.float32))))
    return out


def _pair(seed, eos):
    cfg = dataclasses.replace(TINY_CAP, eos_idx=eos)
    params, model = captioner_pair(cfg, seed)
    return cfg, to_jax_cap(cfg), params, model


def _cross(model, feats):
    with torch.no_grad():
        return model.forward_enc(torch.from_numpy(feats))


def _assert_same_captions(got, want):
    """Captions (tokens up to each length) and lengths equal; log-probs up to
    each length within LP_TOL."""
    got_caps, got_lps = got
    want_caps, want_lps = want
    assert got_caps == want_caps
    for g_img, w_img in zip(got_lps, want_lps):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g, w, rtol=0, atol=LP_TOL)


def _decode_kw(eos, chunks, **kw):
    return dict(beam_size=BEAM, how_many_outputs=BEAM, max_seq_len=L_BEAM, sos_idx=2,
                eos_idx=eos, chunk_schedule=chunks, **kw)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first", [11, 12, 16])
def test_default_chunk_schedule_equals_jax(first):
    for L in range(1, 201):
        assert pbs.default_chunk_schedule(L, first) == jbs.default_chunk_schedule(L, first), L
    assert pbs.default_chunk_schedule(74) == (12, 24, 40, 56, 74)
    assert pbs.default_chunk_schedule(20) == (12, 20)
    assert pbs.default_chunk_schedule(16) == (16,)


class _Ran(Exception):
    """Raised where a JAX loop got past its checks of the schedule."""


def _jax_beam_loop_refuses(chunks, L):
    """Whether the JAX beam loop refuses `chunks`: it runs step 1 through a
    stub step, checks the schedule (the evenness rule under its default
    kernel step's double buffer), then traces its loop body, where the stub
    stops it."""
    def step_fn(muts, tokens, pos, reorder=None, group=1, dst=None):
        if reorder is not None:  # the loop body: the schedule passed
            raise _Ran
        return jnp.zeros((tokens.shape[0], 6), jnp.float32), muts

    dcfg = JDecodeConfig(beam_size=2, max_seq_len=L, sos_idx=0, eos_idx=1)
    try:
        jbs.beam_loop(step_fn, {}, 1, dcfg, double_buffer=True, chunks=chunks)
    except _Ran:
        return False
    except (AssertionError, IndexError):
        return True
    raise AssertionError("the JAX beam loop neither refused the schedule nor ran")


def _jax_sample_refuses(chunks, L):
    """Whether the JAX sampler refuses `chunks`: it checks the schedule before
    it builds its decoder state, where a stub stops it."""
    with mock.patch.object(jdc, "init_state", side_effect=_Ran):
        try:
            jsmp.sample(None, None, jnp.zeros((1, 2, 4)), 1, L, jax.random.PRNGKey(0), 0, 1,
                        chunks=chunks)
        except _Ran:
            return False
        except (AssertionError, IndexError):
            return True
    raise AssertionError("the JAX sampler neither refused the schedule nor ran")


def _port_refuses(chunks, L, even):
    try:
        pbs.check_schedule(chunks, L, even=even)
    except ValueError:
        return True
    return False


@st.composite
def _schedules(draw):
    """(chunks, max_seq_len): short tuples of small ints, half of them sorted,
    unique and ending at max_seq_len (so that the evenness and sign rules
    decide)."""
    L = draw(st.integers(1, 24))
    chunks = draw(st.lists(st.integers(-2, 26), min_size=1, max_size=4))
    if draw(st.booleans()):
        chunks = sorted({c for c in chunks if c < L}) + [L]
    return tuple(chunks), L


@settings(max_examples=80, deadline=None)
@given(_schedules())
def test_schedules_the_jax_loops_refuse_are_refused(case):
    """Every schedule the JAX beam loop or sampler refuses, the port refuses
    (ValueError); the port refuses no other but a first chunk below 1."""
    chunks, L = case
    for even, jax_refuses in ((True, _jax_beam_loop_refuses), (False, _jax_sample_refuses)):
        refused = jax_refuses(chunks, L)
        if refused:
            assert _port_refuses(chunks, L, even), (chunks, L, even)
        elif _port_refuses(chunks, L, even):
            assert chunks[0] < 1, (chunks, L, even)


def test_entry_points_refuse_bad_schedules_and_take_the_default_for_none():
    cfg, _, _, model = _pair(0, 14)
    cross = _cross(model, _features(0))
    for bad in ((7, 17), (10, 6, 17), (6, 16), (0, 17)):
        with pytest.raises(ValueError, match="chunk schedule"):
            pbs.beam_search(model, cfg, cross, PDecodeConfig(**_decode_kw(14, bad)))
    with pytest.raises(ValueError, match="chunk schedule"):
        psmp.sample(model, cfg, cross, 2, 18, 2, 14, chunks=(12, 6, 18),
                    generator=torch.Generator().manual_seed(0))
    # odd chunks are the beam loop's refusal only: the sampler takes them
    psmp.sample(model, cfg, cross, 2, 18, 2, 14, chunks=(5, 18),
                generator=torch.Generator().manual_seed(0))
    # None and () both mean the default, as in the JAX package
    assert pbs.schedule_of(PDecodeConfig(max_seq_len=74)) == (12, 24, 40, 56, 74)
    assert pbs.schedule_of(PDecodeConfig(max_seq_len=20, chunk_schedule=())) == (12, 20)


# ---------------------------------------------------------------------------
# the decode loops against the JAX package at the same chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step_impl", pdc.STEP_IMPLS)
@pytest.mark.parametrize("chunks", [(6, 10, 17), None], ids=["6-10-17", "default"])
@pytest.mark.parametrize("seed, eos", EOS_CASES)
def test_beam_search_chunked_equals_jax(seed, eos, chunks, step_impl):
    cfg, jc, params, model = _pair(seed, eos)
    feats = _features(seed)
    kw = _decode_kw(eos, chunks)
    want = jbs.captions_from_result(jax.jit(lambda p, x: jbs.beam_search(
        p, jc, jcap.forward_enc(p, jc, x), JDecodeConfig(**kw)))(params, jnp.asarray(feats)))
    got = pbs.captions_from_result(pbs.beam_search(
        model, cfg, _cross(model, feats), PDecodeConfig(**kw), step_impl=step_impl))
    _assert_same_captions(got, want)
    lengths = {len(c) for img in got[0] for c in img}
    assert len(lengths) > 1  # beams end at different steps


@pytest.mark.parametrize("chunks", [(6, 10, 17), None], ids=["6-10-17", "default"])
def test_ensemble_chunked_equals_jax(chunks):
    eos = 14
    pairs = [_pair(s, eos) for s in (0, 1)]
    jc = pairs[0][1]
    feats = _features(4)
    kw = _decode_kw(eos, chunks)
    encs_j = [jcap.forward_enc(p, jc, jnp.asarray(feats)) for _, _, p, _ in pairs]
    want = jbs.captions_from_result(jbs.ensemble_beam_search(
        [p for _, _, p, _ in pairs], jc, encs_j, JDecodeConfig(**kw)))
    got = pbs.captions_from_result(pbs.ensemble_beam_search(
        [m for *_, m in pairs], pairs[0][0], [_cross(m, feats) for *_, m in pairs],
        PDecodeConfig(**kw)))
    _assert_same_captions(got, want)


@pytest.mark.parametrize("chunks", [(6, 10, 17), None], ids=["6-10-17", "default"])
def test_sampled_beams_chunked_equal_jax(chunks):
    cfg, jc, params, model = _pair(0, 14)
    feats = _features(8)
    kw = _decode_kw(14, chunks, sample_or_max="sample")
    key = jax.random.PRNGKey(2)
    want = jbs.captions_from_result(jbs.beam_search(
        params, jc, jcap.forward_enc(params, jc, jnp.asarray(feats)), JDecodeConfig(**kw),
        rng=key))
    v = cfg.vocab_size
    noise = _gumbel_chain(key, [(2, v)] + [(2 * BEAM, v)] * (L_BEAM - 2))
    got = pbs.captions_from_result(pbs.beam_search(
        model, cfg, _cross(model, feats), PDecodeConfig(**kw), noise=noise))
    _assert_same_captions(got, want)
    greedy = pbs.captions_from_result(pbs.beam_search(
        model, cfg, _cross(model, feats), PDecodeConfig(**_decode_kw(14, chunks))))
    assert greedy[0] != got[0]  # the noise did change the beams


@pytest.mark.parametrize("step_impl", pdc.STEP_IMPLS)
@pytest.mark.parametrize("chunks", [(6, 12, 18), (4, 18), None], ids=["6-12-18", "4-18", "default"])
def test_sampling_chunked_equals_jax(chunks, step_impl):
    cfg, jc, params, model = _pair(5, 7)
    feats = _features(5)
    pads = np.array([0, 2], np.int32)
    key = jax.random.PRNGKey(4)
    cross_j = jcap.forward_enc(params, jc, jnp.asarray(feats), enc_num_pads=jnp.asarray(pads))
    want = jsmp.sample(params, jc, cross_j, N_SAMPLES, L_SAMPLE, key, 2, 7,
                       enc_num_pads=jnp.asarray(pads), chunks=chunks)
    noise = _gumbel_chain(key, [(2 * N_SAMPLES, cfg.vocab_size)] * L_SAMPLE)
    with torch.no_grad():
        cross = model.forward_enc(torch.from_numpy(feats), torch.from_numpy(pads))
    got = psmp.sample(model, cfg, cross, N_SAMPLES, L_SAMPLE, 2, 7,
                      enc_num_pads=torch.from_numpy(pads), step_impl=step_impl, noise=noise,
                      chunks=chunks)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=0, atol=LP_TOL)
    lengths = got.lengths.numpy()
    assert (lengths < L_SAMPLE).any() and (lengths > 12).any()  # EOS early and late


def test_captioner_defaults_decode_chunked_like_the_jax_api():
    """`api.Captioner` with no schedule decodes in the default phases ((12,
    20) at 20 tokens), as the JAX `api.Captioner` does: the same captions,
    the caches allocated at 12 positions and grown to 20."""
    cfg, jc, params, model = _pair(0, 14)
    feats = _features(9)
    pads = np.array([0, 2], np.int32)
    args = {"beam_size": BEAM, "how_many_outputs": 2, "beam_max_seq_len": 20}
    want = japi.Captioner(params, jc, args)(feats, enc_x_num_pads=pads)
    lengths = []
    real_init, real_grow = pdc.init_state, pdc.grow_state

    def init_state(*a, **k):
        state = real_init(*a, **k)
        lengths.append(state.length)
        return state

    def grow_state(state, new_len):
        grown = real_grow(state, new_len)
        if grown is not state:
            lengths.append(grown.length)
        return grown

    with mock.patch.object(pdc, "init_state", init_state), \
            mock.patch.object(pdc, "grow_state", grow_state):
        got = Captioner(model, cfg, args, device="cpu")(feats, enc_x_num_pads=pads)
    _assert_same_captions(got, want)
    assert lengths == [12, 20]


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks", [(2, 17), (2, 4, 8, 16, 17), (12, 17), (16, 17)])
@pytest.mark.parametrize("sample", [False, True], ids=["max", "sample"])
def test_chunked_beams_equal_one_phase(chunks, sample):
    cfg, _, _, model = _pair(0, 14)
    cross = _cross(model, _features(3))
    mode = {"sample_or_max": "sample"} if sample else {}
    noise = _gumbel_chain(jax.random.PRNGKey(7), [(2, cfg.vocab_size)]
                          + [(2 * BEAM, cfg.vocab_size)] * (L_BEAM - 2))
    one = pbs.captions_from_result(pbs.beam_search(
        model, cfg, cross, PDecodeConfig(**_decode_kw(14, (L_BEAM,), **mode)), noise=noise))
    got = pbs.captions_from_result(pbs.beam_search(
        model, cfg, cross, PDecodeConfig(**_decode_kw(14, chunks, **mode)), noise=noise))
    _assert_same_captions(got, one)


@pytest.mark.parametrize("chunks", [(1, 5, 18), (17, 18), (2, 3, 4, 18)])
def test_chunked_sampling_equals_one_phase(chunks):
    cfg, _, _, model = _pair(5, 7)
    cross = _cross(model, _features(6))
    noise = _gumbel_chain(jax.random.PRNGKey(8), [(2 * N_SAMPLES, cfg.vocab_size)] * L_SAMPLE)
    one = psmp.sample(model, cfg, cross, N_SAMPLES, L_SAMPLE, 2, 7, noise=noise,
                      chunks=(L_SAMPLE,))
    got = psmp.sample(model, cfg, cross, N_SAMPLES, L_SAMPLE, 2, 7, noise=noise, chunks=chunks)
    assert torch.equal(got.tokens, one.tokens) and torch.equal(got.lengths, one.lengths)
    torch.testing.assert_close(got.logprobs, one.logprobs, rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("chunks", [(6, 10, 17), None], ids=["6-10-17", "default"])
@pytest.mark.parametrize("seed, eos", EOS_CASES)
def test_fixed_beam_search_equals_early_exit_under_one_schedule(seed, eos, chunks):
    cfg, _, _, model = _pair(seed, eos)
    cross = _cross(model, _features(seed))
    dcfg = PDecodeConfig(**_decode_kw(eos, chunks))
    want = pbs.beam_search(model, cfg, cross, dcfg)
    with torch.no_grad():
        got = pbs.fixed_beam_search(model, cfg, cross, dcfg)
    assert torch.equal(got.lengths, want.lengths)
    for i, row in enumerate(got.lengths.tolist()):
        for j, n in enumerate(row):
            assert torch.equal(got.tokens[i, j, :n], want.tokens[i, j, :n])
            assert torch.equal(got.logprobs[i, j, :n], want.logprobs[i, j, :n])


def test_grow_state_pads_positions_and_keeps_the_encoder_side():
    cfg, _, _, model = _pair(0, 14)
    cross = _cross(model, _features(0))
    state = pdc.init_state(model, cfg, cross, 6, enc_num_pads=torch.tensor([0, 2]))
    sos = torch.full((2,), 2, dtype=torch.int32)
    _, state = pdc.dec_step(model, cfg, state, sos, 0)
    assert state.spare is not None and state.length == 6
    grown = pdc.grow_state(state, 10)
    assert grown.length == 10 and grown.spare is None
    assert grown.cross is state.cross and grown.enc_mask is state.enc_mask
    for old, new in zip(state.caches, grown.caches):
        for a, b in zip(old, new):
            assert b.shape == (a.shape[0], 10, *a.shape[2:]) and b.dtype == a.dtype
            assert torch.equal(b[:, :6], a) and not b[:, 6:].any()
    assert pdc.grow_state(grown, 10) is grown and pdc.grow_state(grown, 8) is grown


def test_step_never_writes_a_spare_set_of_another_length():
    """A state whose current caches were grown but whose spare set kept the
    old length (as a state grown by hand would): the step allocates a spare
    set of the current length and decodes as from a state without one."""
    cfg, _, _, model = _pair(0, 14)
    cross = _cross(model, _features(0))
    state = pdc.init_state(model, cfg, cross, 6)
    _, state = pdc.dec_step(model, cfg, state, torch.full((2,), 2, dtype=torch.int32), 0)
    grown = pdc.grow_state(state, 10)
    kept = pdc.DecState(caches=grown.caches, spare=state.spare, cross=grown.cross,
                        enc_mask=grown.enc_mask)
    assert kept.spare[0][0].shape[1] == 6
    tokens = torch.tensor([7, 9], dtype=torch.int32)
    lp, new = pdc.dec_step(model, cfg, kept, tokens, 1)
    lp_ref, ref = pdc.dec_step(model, cfg, grown, tokens, 1)
    assert torch.equal(lp, lp_ref)
    for layer, layer_ref in zip(new.caches, ref.caches):
        for a, b in zip(layer, layer_ref):
            assert a.shape[1] == 10 and torch.equal(a, b)


def test_exported_engine_follows_the_schedule(tmp_path):
    """The engine of `deploy/aot.py` at 20 tokens runs the default (12, 20)
    schedule (its manifest says so) and gives the JAX `caption_fn`'s tokens
    and lengths, which decodes in the same phases."""
    cfg = dataclasses.replace(TINY_E2E, captioner=dataclasses.replace(
        TINY_E2E.captioner, vocab_size=50))
    jparams, model = e2e_pair(cfg, 3)
    dcfg = PDecodeConfig(beam_size=2, how_many_outputs=1, max_seq_len=20, sos_idx=2, eos_idx=3)
    art = str(tmp_path / "engine")
    aot.export_artifact(art, model, cfg, dcfg, batch_size=2)
    assert aot.load_manifest(art)["chunk_schedule"] == [12, 20]
    call, params = aot.load_artifact(art)
    imgs = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    toks, lengths = call(params, torch.from_numpy(imgs))
    jc = to_jax_model(cfg, attention_impl="xla")
    jd = JDecodeConfig(beam_size=2, how_many_outputs=1, max_seq_len=20, sos_idx=2, eos_idx=3)
    want_t, want_l = jax.jit(jaot.caption_fn(jc, jd))(jparams, jnp.asarray(imgs))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_l))
    for i, n in enumerate(lengths.tolist()):
        np.testing.assert_array_equal(toks[i, :n].numpy(), np.asarray(want_t)[i, :n])


def test_scst_sampler_takes_the_default_schedule():
    """The SCST step's sampler at 20 tokens allocates 12 + 1 positions and
    grows to 20 + 1 (noise that never picks EOS keeps every row going), as
    the JAX SCST step's default schedule does."""
    cfg, _, _, model = _pair(5, 7)
    feats = _features(10)
    batch = {"enc_input": torch.from_numpy(feats), "enc_num_pads": torch.tensor([0, 1])}
    noise = _gumbel_chain(jax.random.PRNGKey(3), [(2 * N_SAMPLES, cfg.vocab_size)] * 20)
    for g in noise:
        g[:, cfg.eos_idx] = -1e9
    step = pstep.make_scst_fused_step(
        model, cfg, pradam.PlainRAdam(model.parameters(), 1e-2), N_SAMPLES, 20, 2,
        cfg.eos_idx, lambda tokens, lengths, tables: lengths.float())
    lengths = []
    real_grow = pdc.grow_state

    def grow_state(state, new_len):
        lengths.append(new_len)
        return real_grow(state, new_len)

    with mock.patch.object(pdc, "grow_state", grow_state):
        out = step(batch, None, noise=noise)
    assert sorted(set(lengths)) == [13, 21]
    assert out["sampled"].tokens.shape == (2, N_SAMPLES, 21)
    assert (out["sampled"].lengths == 20).all()


def test_quantized_decode_grows_like_the_dense_one():
    """A w8a8-quantized caption head (int8 `QuantLinear` projections of the
    step) decodes in phases to the captions of one phase."""
    from on_device_image_captioning_torch.deploy.quantization import quantize_model

    cfg, _, _, model = _pair(0, 14)
    quantize_model(model, "w8a8")
    cross = _cross(model, _features(3))
    got, one = (pbs.captions_from_result(pbs.beam_search(
        model, cfg, cross, PDecodeConfig(**_decode_kw(14, chunks))))
        for chunks in ((6, 10, 17), (L_BEAM,)))
    _assert_same_captions(got, one)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tensor_parallel_decode_grows_whole_caches_on_positions(tmp_path):
    """Two gloo ranks, one model group, the caption head cut over it
    (`tests/_torch_chunked_tp_worker.py`): the model axis cuts no cache, so
    every cache keeps its whole width and grows on its position axis alone
    (to 8, then 16); on each rank and step path the chunked captions equal
    one phase's (log-probs within LP_TOL) and one process's chunked decode of
    the whole model (log-probs within 1e-4: the model group sums its partial
    products in another order)."""
    import _torch_chunked_tp_worker as cw

    _, model = captioner_pair(cw.TP_CAP, 12)
    torch.save(model.state_dict(), tmp_path / "cap.pt")
    feats = _features(13, b=2, s=6)
    np.save(tmp_path / "feats.npy", feats)
    port = _free_port()
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, cw.__file__, str(rank), str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a worker did not finish within 120 s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(2)]
    cap, L = cw.TP_CAP, cw.L
    chunked, one = cw.CHUNKS
    d, e = cap.d_model, cap.num_exp_dec
    with torch.no_grad():
        cross = model.forward_enc(torch.from_numpy(feats))
    for out in outs:
        # two growths a chunked decode (to 8, to 16), one decode per step path
        assert [shapes[0][1] for shapes in out["grown"]] == [8, L] * len(cw.STEP_IMPLS)
        rows = 2 * cw.BEAM
        for shapes in out["grown"]:
            n = shapes[0][1]
            assert shapes == ([(rows, n, d)] * 4 + [(rows, n, e, d)] * 2) * cap.N_dec
        for impl in cw.STEP_IMPLS:
            _assert_same_captions(out[(chunked, impl)], out[(one, impl)])
            whole = pbs.captions_from_result(pbs.beam_search(
                model, cap, cross, PDecodeConfig(
                    beam_size=cw.BEAM, how_many_outputs=cw.BEAM, max_seq_len=L,
                    sos_idx=cap.sos_idx, eos_idx=cap.eos_idx, chunk_schedule=chunked),
                step_impl=impl))
            assert out[(chunked, impl)][0] == whole[0]
            for g_img, w_img in zip(out[(chunked, impl)][1], whole[1]):
                for g, w in zip(g_img, w_img):
                    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the decode-step plans at the schedules' cache lengths
# ---------------------------------------------------------------------------


def _cell_shapes():
    """(rows, cache length) of every step the default schedules run in the
    serve (b8 / beam 3 / L20), latency (b1 / beam 5 / L74) and SCST (b4 x 5
    samples / L20, caches of chunk + 1) cells: the SOS step on one row an
    image at the first chunk, then the beams' rows at every chunk."""
    shapes = set()
    for b, k, L in ((8, 3, 20), (1, 5, 74)):
        chunks = pbs.default_chunk_schedule(L)
        shapes.add((b, chunks[0]))
        shapes.update((b * k, c) for c in chunks)
    shapes.update((4 * 5, c + 1) for c in pbs.default_chunk_schedule(20))
    return sorted(shapes)


CELL_SHAPES = _cell_shapes()


def test_cell_shapes_are_the_schedules():
    assert CELL_SHAPES == [(1, 12), (5, 12), (5, 24), (5, 40), (5, 56), (5, 74), (8, 12),
                           (20, 13), (20, 21), (24, 12), (24, 20)]


@pytest.mark.parametrize("rows, L", CELL_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads", [0, 8])
def test_step_plan_at_the_schedules_lengths(rows, L, itemsize, heads):
    """K2 (heads 0) and B16 (8 heads over 144 encoder tokens) plan every
    chunk length on an H100 (132 SMs): the row's clusters take its L
    positions once, within one wave of the card, in the shared memory a CTA
    may have."""
    plan = pk2.step_plan(rows, L, 16, 512, itemsize, heads, 144 if heads else 0, sms=132)
    seen = [p for c in range(plan.chunks) for p in plan.chunk_positions(c, L)]
    assert seen == list(range(L))
    assert plan.ctas <= pk2.CTAS_PER_SM * 132 or plan.chunks == 1
    assert plan.shared_bytes <= pk2.MAX_SHARED
