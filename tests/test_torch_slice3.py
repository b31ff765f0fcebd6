"""The serving path as the JAX package picks it, and the rest of inference,
in the port against the JAX package on the CPU: the whole-block Swin kernel
and the backbone's stage modes, the fused decode step with cross-attention,
encoder pads through decode, sampling, sampled beams, ensembles and the
features-in `Captioner`.

Inputs come from numpy with a seed and go through the JAX function (a Pallas
kernel in interpret mode wherever the JAX path reaches one) and its counterpart
in the port (on the CPU the plain version of each kernel). JAX and PyTorch
draw different numbers from one seed, so wherever noise enters, the test draws
the Gumbel noise from the JAX key chain and hands the port the same numbers.

Tolerances, each stated where it is used: the whole block fp32 atol = rtol =
2e-5 (summation order, and the TPU kernel's polynomial erf against the exact
erf here) and bf16 2e-2 (both sides round at the same places: one bf16 ulp);
`dec_step` log-probs fp32 5e-5 and bf16 5e-2 absolute, the JAX package's own
for this step (`tests/test_pallas_ops.py`); tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.api import Captioner, EnsembleCaptioner
from on_device_image_captioning_torch.config import DecodeConfig as PDecodeConfig
from on_device_image_captioning_torch.decode import beam_search as pbs
from on_device_image_captioning_torch.decode import cache as pdc
from on_device_image_captioning_torch.decode import sampling as psmp
from on_device_image_captioning_torch.models.swin import (
    SwinTransformer, default_stage_mode, shift_attn_mask,
)
from on_device_image_captioning_torch.ops import dyn_exp_step as pk2
from on_device_image_captioning_torch.ops import swin_block_fused as psbf
from on_device_image_captioning_tpu import api as japi
from on_device_image_captioning_tpu.config import DecodeConfig as JDecodeConfig
from on_device_image_captioning_tpu.decode import beam_search as jbs
from on_device_image_captioning_tpu.decode import cache as jdc
from on_device_image_captioning_tpu.decode import sampling as jsmp
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.models import swin as jswin
from on_device_image_captioning_tpu.ops import dyn_exp_step as jk2
from on_device_image_captioning_tpu.ops import swin_block_fused as jsbf

from test_torch_fused_path import (
    BACKBONE, C, EPS, HEADS, N, NW, RES, SHIFT, TOL, WINDOW, _backbone_pair, _linear, _norm,
    _np, _pair,
)
from test_torch_harness import TINY_CAP, captioner_pair, jax_pallas_path, to_jax_cap

DTYPES = ["float32", "bfloat16"]


# ---------------------------------------------------------------------------
# B6: the whole block, and the backbone's stage modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("transition", [False, True], ids=["no_transition", "transition"])
def test_swin_block_matches_jax_kernel(dtype, masked, transition):
    """`swin_block` against `swin_block_fused`: a masked block runs in the
    shifted layout (transition 0 -> shift), a plain one in the unshifted
    (transition shift -> 0). fp32 2e-5, bf16 2e-2."""
    rng = np.random.default_rng(11)
    jx, px = _pair(rng.standard_normal((2 * NW, N, C)).astype(np.float32), dtype)
    jn1, pn1 = _norm(rng, C)
    jqkv, pqkv = _linear(rng, C, 3 * C, dtype)
    jproj, pproj = _linear(rng, C, C, dtype)
    jn2, pn2 = _norm(rng, C)
    jfc1, pfc1 = _linear(rng, C, 4 * C, dtype)
    jfc2, pfc2 = _linear(rng, 4 * C, C, dtype)
    bias = (0.5 * rng.standard_normal((HEADS, N, N))).astype(np.float32)
    mask = shift_attn_mask(RES, WINDOW, SHIFT) if masked else None
    shifts = None if not transition else ((0, SHIFT) if masked else (SHIFT, 0))
    scale = (C // HEADS) ** -0.5
    kw = {}
    if shifts is not None:
        dr, dc, p4 = jswin.transition_pieces(RES, WINDOW, *shifts)
        kw = dict(transition=(dr, dc, RES // WINDOW), p4=jnp.asarray(p4))
    params = {"norm1": jn1, "attn": {"qkv": jqkv, "proj": jproj}, "norm2": jn2,
              "mlp": {"fc1": jfc1, "fc2": jfc2}}
    want = jsbf.swin_block_fused(
        jx, params, jnp.asarray(bias), None if mask is None else jnp.asarray(mask), HEADS, NW,
        scale, EPS, **kw)
    before = psbf.block_launches
    got = psbf.swin_block(
        px, pn1, pqkv, pproj, pn2, pfc1, pfc2, torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), HEADS, scale, EPS,
        None if shifts is None else (RES, *shifts))
    assert psbf.block_launches == before  # the plain version on the CPU: no launch
    assert got.shape == want.shape and str(got.dtype) == "torch." + dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_default_stage_modes_are_the_jax_package_s_at_swin_l():
    """"full" for widths 192 and 384, "halves" for 768: what `eligible` gives
    at Swin-L in bf16."""
    for width in (192, 384, 768):
        want = "full" if jsbf.eligible(width, 4.0, jnp.bfloat16) else "halves"
        assert default_stage_mode(width) == want
    assert SwinTransformer(BACKBONE).stage_modes == {0: "full", 1: "full"}
    assert SwinTransformer(BACKBONE, {1: "halves"}).stage_modes == {0: "full", 1: "halves"}
    with pytest.raises(ValueError, match="stage_modes"):
        SwinTransformer(BACKBONE, {0: "hybrid"})
    with pytest.raises(ValueError, match="stage_modes"):
        SwinTransformer(BACKBONE, {5: "full"})


@pytest.mark.parametrize(
    "modes",
    [None, {0: "halves"}, {1: "halves"}, {0: "halves", 1: "halves"}, {0: "full", 1: "full"}],
    ids=["default", "stage0_halves", "stage1_halves", "all_halves", "all_full"],
)
def test_fused_backbone_stage_modes_match_jax(modes):
    """The "fused" backbone with its default modes and with each override
    against `swin_apply` under the same `set_stage_mode_override`. fp32 2e-5."""
    jc, params, _ = _backbone_pair(BACKBONE, 9)
    model = SwinTransformer(BACKBONE, modes).eval()
    model.load_state_dict(_backbone_pair(BACKBONE, 9)[2].state_dict())
    imgs = np.random.default_rng(19).standard_normal((2, 64, 64, 3)).astype(np.float32)
    try:
        jswin.set_stage_mode_override(modes)
        with jax_pallas_path():
            want = jax.jit(lambda p, x: jswin.swin_apply(p, jc, x))(
                jswin.prepare_inference_params(params, jc), jnp.asarray(imgs))
    finally:
        jswin.set_stage_mode_override(None)
    model.prepare_inference()
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    expected = {0: "full", 1: "full", **(modes or {})}
    assert model.stage_modes == expected
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# B16: the decode step with its cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_dyn_exp_cross_step_matches_jax_kernel(dtype):
    """The wrapper (plain version on the CPU) against
    `dyn_exp_cross_step_pallas` on the same operands: grouped rows, a pad
    mask, a shuffled reorder. fp32 5e-5, bf16 5e-2 on the output row; the
    caches as the step kernel's own test holds them (1e-5 / 1e-2)."""
    rng = np.random.default_rng(21)
    b_img, group, L, E, d, heads, S = 2, 3, 7, 4, 32, 4, 6
    b = b_img * group
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def rnd(a):  # round once so both sides start from equal values
        return torch.from_numpy(a).to(td).float().numpy()

    src = [rnd(arr(b, L, d)) for _ in range(4)] + [rnd(arr(b, L, E, d)) for _ in range(2)]
    q_i, bias_i = rnd(arr(b, E, d)), rnd(arr(b, E, d))
    rows = [rnd(arr(b, d)) for _ in range(4)]
    sel = 1.0 / (1.0 + np.exp(-arr(b, d)))
    embed = rnd(arr(E, d))
    y = arr(b, d)
    g2, b2 = 1.0 + 0.2 * arr(d), 0.2 * arr(d)
    wq, wo = rnd(arr(d, d, scale=d**-0.5)), rnd(arr(d, d, scale=d**-0.5))
    bq, bo = 0.2 * arr(d), 0.2 * arr(d)
    kc, vc = rnd(arr(b_img, S, d)), rnd(arr(b_img, S, d))
    mask = (np.arange(S)[None, :] < (S - np.array([0, 2]))[:, None]).astype(np.float32)
    reorder = (rng.integers(0, group, b) + (np.arange(b) // group) * group).astype(np.int32)
    pos = 3

    ja = lambda a, dt=jd: jnp.asarray(a).astype(dt)  # noqa: E731
    ta = lambda a, dt=td: torch.from_numpy(np.asarray(a, np.float32)).to(dt)  # noqa: E731
    want = jk2.dyn_exp_cross_step_pallas(
        jnp.int32(pos), ja(q_i), ja(bias_i), *(ja(r) for r in rows), ja(sel, jnp.float32),
        ja(embed), ja(y, jnp.float32), {"scale": jnp.asarray(g2), "bias": jnp.asarray(b2)},
        ja(wq), jnp.asarray(bq), ja(wo), jnp.asarray(bo), ja(kc), ja(vc), jnp.asarray(mask),
        *(ja(s) for s in src), heads=heads, ln_eps=1e-5, attn_fill=-1e4, group=group,
        eps=1e-9, reorder=jnp.asarray(reorder), compute_dtype=jd)
    tsrc = [ta(s) for s in src]
    dst = [torch.empty_like(s) for s in tsrc]
    before = pk2.cross_launches
    got = pk2.dyn_exp_cross_step(
        pos, torch.from_numpy(reorder), ta(q_i), ta(bias_i), *(ta(r) for r in rows),
        ta(sel, torch.float32), ta(embed), ta(y, torch.float32),
        (torch.from_numpy(g2), torch.from_numpy(b2)), ta(wq), torch.from_numpy(bq), ta(wo),
        torch.from_numpy(bo), ta(kc), ta(vc), torch.from_numpy(mask), tsrc, dst,
        heads=heads, ln_eps=1e-5, attn_fill=-1e4, group=group, eps=1e-9, compute_dtype=td)
    assert pk2.cross_launches == before and got.dtype == torch.float32
    tol = 5e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want[0]), atol=tol, rtol=0)
    cache_tol = 1e-5 if dtype == "float32" else 1e-2
    for name, g_, w_ in zip(("keys", "ca", "cb", "cond", "va", "vb"), dst, want[1:]):
        np.testing.assert_allclose(_np(g_), np.asarray(w_.astype(jnp.float32)),
                                   atol=cache_tol, rtol=cache_tol, err_msg=name)


STEP_CFG = dataclasses.replace(
    TINY_CAP, N_enc=1, N_dec=1, num_exp_enc_list=(4,), max_seq_len=10, img_feature_dim=32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dec_step_fused_matches_jax_over_three_positions(dtype):
    """`dec_step` under step_impl "pallas" and "pallas_fused" against the JAX
    `dec_step` under "xla" and "pallas_fused": three positions, grouped rows
    (2 images x 2), encoder pads [0, 2], shuffled reorders (mirrors
    `test_dyn_cross_fused_step_matches_xla_and_unfused`). Log-probs within
    5e-5 absolute at fp32 and 5e-2 at bf16."""
    params, model = captioner_pair(STEP_CFG, 0)
    jc = to_jax_cap(STEP_CFG)
    rng = np.random.default_rng(0)
    b_img, group = 2, 2
    b = b_img * group
    enc = rng.standard_normal((b_img, 6, 32)).astype(np.float32)
    pads = np.array([0, 2], np.int32)
    toks = rng.integers(0, 50, (b,)).astype(np.int32)
    reorders = [None] + [
        (rng.integers(0, group, (b,)) + (np.arange(b) // group) * group).astype(np.int32)
        for _ in range(2)]
    jdt, tdt, tol = ((None, None, 5e-5) if dtype == "float32"
                     else (jnp.bfloat16, torch.bfloat16, 5e-2))
    cache_j = jnp.float32 if jdt is None else jdt
    cache_t = torch.float32 if tdt is None else tdt

    st0 = jdc.init_state(params, jc, jnp.asarray(enc), 10, cache_dtype=cache_j,
                         enc_num_pads=jnp.asarray(pads))
    muts, static = jdc.split_state(st0)
    rep = jnp.repeat(jnp.arange(b_img), group)
    st = jdc.merge_state(
        [jdc.MutCaches(*(jnp.take(a, rep, axis=0) for a in m)) for m in muts], static)
    want = {}
    for impl in ("xla", "pallas_fused"):
        jdc.set_dyn_step_impl(impl)
        try:
            state, ys = st, []
            for pos in range(3):
                lp, state = jdc.dec_step(
                    params, jc, state, jnp.asarray(toks), jnp.int32(pos), dtype=jdt,
                    reorder=None if reorders[pos] is None else jnp.asarray(reorders[pos]),
                    group=group)
                ys.append(np.asarray(lp, np.float32))
            want[impl] = np.stack(ys)
        finally:
            jdc.set_dyn_step_impl("xla")

    expand = np.repeat(np.arange(b_img), group).astype(np.int32)
    got = {}
    for impl in pdc.STEP_IMPLS:
        state = pdc.init_state(model, STEP_CFG, torch.from_numpy(enc), 10, cache_t,
                               torch.from_numpy(pads))
        assert state.enc_mask.tolist() == [[1.0] * 6, [1.0] * 4 + [0.0] * 2]
        ys = []
        for pos in range(3):
            reorder = expand if pos == 0 else reorders[pos]
            lp, state = pdc.dec_step(
                model, STEP_CFG, state, torch.from_numpy(toks), pos, tdt,
                torch.from_numpy(reorder), group, impl)
            ys.append(lp.numpy())
        got[impl] = np.stack(ys)
    for impl in pdc.STEP_IMPLS:
        for ref in ("xla", "pallas_fused"):
            np.testing.assert_allclose(got[impl], want[ref], atol=tol, rtol=0,
                                       err_msg=f"port {impl} vs jax {ref}")
    with pytest.raises(ValueError, match="step_impl"):
        pdc.dec_step(model, STEP_CFG, state, torch.from_numpy(toks), 3, tdt, None, group, "xla")


def test_fused_step_operands_follow_the_weights():
    """The fused step keeps its laid-out Wq / out_linear on the layer; weights
    loaded into the model afterwards must be laid out anew. Exact equality
    with a model that never held the old weights."""
    _, model = captioner_pair(STEP_CFG, 0)
    _, other = captioner_pair(STEP_CFG, 1)
    enc = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 6, 32)).astype(np.float32))
    toks = torch.tensor([5, 9], dtype=torch.int32)

    def first_step(m):
        state = pdc.init_state(m, STEP_CFG, enc, 10)
        return pdc.dec_step(m, STEP_CFG, state, toks, 0, step_impl="pallas_fused")[0]

    with torch.inference_mode():
        before = first_step(model)
        model.load_state_dict(other.state_dict())
        after, want = first_step(model), first_step(other)
    assert torch.equal(after, want) and not torch.allclose(after, before)


# ---------------------------------------------------------------------------
# pads, sampling, sampled beams, ensembles, the features-in Captioner
# ---------------------------------------------------------------------------


def _gumbel_chain(key, shapes):
    """The Gumbel noise the JAX decode loops draw: one `split` per draw."""
    out = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("step_impl", pdc.STEP_IMPLS)
def test_padded_features_caption_like_truncated_ones_and_like_jax(step_impl):
    """Feature rows with trailing pad junk and enc_num_pads set caption like
    the truncated features, and like the JAX package on the padded batch
    (mirrors `test_beam_padded_features_match_unpadded`). Tokens exactly;
    log-probs within 1e-4 (fp32 through the stacks)."""
    params, model = captioner_pair(TINY_CAP, 3)
    jc = to_jax_cap(TINY_CAP)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 6, TINY_CAP.img_feature_dim)).astype(np.float32)
    junk = (100.0 * rng.standard_normal((2, 4, TINY_CAP.img_feature_dim))).astype(np.float32)
    padded = np.concatenate([feats, junk], axis=1)
    pads = np.array([4, 4], np.int32)
    args = {"beam_size": 3, "how_many_outputs": 3, "beam_max_seq_len": 14}
    captioner = Captioner(model, TINY_CAP, args, device="cpu", step_impl=step_impl)
    base_caps, base_lps = captioner(feats)
    got_caps, got_lps = captioner(padded, enc_x_num_pads=pads)
    assert got_caps == base_caps
    dcfg = JDecodeConfig(beam_size=3, how_many_outputs=3, max_seq_len=14, sos_idx=2, eos_idx=3)
    cross = jcap.forward_enc(params, jc, jnp.asarray(padded), enc_num_pads=jnp.asarray(pads))
    want = jbs.beam_search(params, jc, cross, dcfg, enc_num_pads=jnp.asarray(pads))
    want_caps, want_lps = jbs.captions_from_result(want)
    assert got_caps == want_caps
    for g_img, w_img in zip(got_lps, want_lps):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    # heterogeneous pads against JAX
    pads2 = np.array([0, 3], np.int32)
    cross2 = jcap.forward_enc(params, jc, jnp.asarray(padded), enc_num_pads=jnp.asarray(pads2))
    want2 = jbs.captions_from_result(
        jbs.beam_search(params, jc, cross2, dcfg, enc_num_pads=jnp.asarray(pads2)))[0]
    assert captioner(padded, enc_x_num_pads=pads2)[0] == want2


def _check_sampling_bookkeeping(res, n_img, n_out, L, sos, eos):
    toks = res.tokens.numpy().reshape(n_img * n_out, L + 1)
    lps = res.logprobs.numpy().reshape(n_img * n_out, L + 1)
    lengths = res.lengths.numpy().reshape(n_img * n_out)
    caps = psmp.captions_from_result(res)
    assert (toks[:, 0] == sos).all() and (lps[:, 0] == 0).all()
    for r in range(n_img * n_out):
        if eos in toks[r, 1:].tolist():
            first = 1 + toks[r, 1:].tolist().index(eos)
            assert lengths[r] == first
            assert (lps[r, first + 1:] == 0).all()
        else:
            assert lengths[r] == L
        assert caps[r // n_out][r % n_out] == toks[r, : lengths[r] + 1].tolist()


@pytest.mark.parametrize("step_impl", pdc.STEP_IMPLS)
def test_sampling_bookkeeping_and_tokens_equal_jax_with_shared_noise(step_impl):
    """`sampling.sample`: the bookkeeping of `test_sampling_bookkeeping`, and
    at fp32 the JAX package's tokens and lengths when the port is fed the
    Gumbel noise JAX draws from the same key chain (padded features, 3 samples
    an image). An EOS id these weights sample early exercises the zeroing."""
    cfg = dataclasses.replace(TINY_CAP, eos_idx=7)
    params, model = captioner_pair(cfg, 5)
    jc = to_jax_cap(cfg)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 7, cfg.img_feature_dim)).astype(np.float32)
    pads = np.array([0, 2], np.int32)
    n_out, L = 3, 10
    cross_j = jcap.forward_enc(params, jc, jnp.asarray(feats), enc_num_pads=jnp.asarray(pads))
    key = jax.random.PRNGKey(4)
    want = jsmp.sample(params, jc, cross_j, n_out, L, key, 2, 7,
                       enc_num_pads=jnp.asarray(pads), chunks=(L,))
    noise = _gumbel_chain(key, [(2 * n_out, cfg.vocab_size)] * L)
    with torch.no_grad():
        cross = model.forward_enc(torch.from_numpy(feats), torch.from_numpy(pads))
    got = psmp.sample(model, cfg, cross, n_out, L, 2, 7, enc_num_pads=torch.from_numpy(pads),
                      step_impl=step_impl, noise=noise)
    assert got.tokens.shape == (2, n_out, L + 1) and got.tokens.dtype == torch.int32
    _check_sampling_bookkeeping(got, 2, n_out, L, 2, 7)
    lengths = got.lengths.numpy()
    np.testing.assert_array_equal(lengths, np.asarray(want.lengths))
    assert (lengths < L).any()  # some row did sample EOS
    # rows go on sampling after their EOS until all have one: compare all of it
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=1e-4, atol=1e-4)  # fp32 through the stacks
    # a generator on the tensors' device draws the noise when none is handed in
    a = psmp.sample(model, cfg, cross, n_out, L, 2, 7, step_impl=step_impl,
                    generator=torch.Generator().manual_seed(1))
    b = psmp.sample(model, cfg, cross, n_out, L, 2, 7, step_impl=step_impl,
                    generator=torch.Generator().manual_seed(1))
    _check_sampling_bookkeeping(a, 2, n_out, L, 2, 7)
    assert torch.equal(a.tokens, b.tokens)


def test_sampled_beams_equal_jax_with_shared_noise():
    """`sample_or_max="sample"`: Gumbel top-k candidates. With the noise of
    the JAX key chain the port's beams equal `beam_search`'s at fp32."""
    params, model = captioner_pair(TINY_CAP, 6)
    jc = to_jax_cap(TINY_CAP)
    feats = np.random.default_rng(8).standard_normal(
        (2, 7, TINY_CAP.img_feature_dim)).astype(np.float32)
    k, L = 3, 9
    key = jax.random.PRNGKey(2)
    dcfg = JDecodeConfig(beam_size=k, how_many_outputs=k, max_seq_len=L, sample_or_max="sample",
                         sos_idx=2, eos_idx=3, chunk_schedule=(L,))
    cross_j = jcap.forward_enc(params, jc, jnp.asarray(feats))
    want = jbs.captions_from_result(jbs.beam_search(params, jc, cross_j, dcfg, rng=key))
    v = TINY_CAP.vocab_size
    noise = _gumbel_chain(key, [(2, v)] + [(2 * k, v)] * (L - 2))
    with torch.no_grad():
        cross = model.forward_enc(torch.from_numpy(feats))
    pcfg_ = PDecodeConfig(beam_size=k, how_many_outputs=k, max_seq_len=L,
                          sample_or_max="sample", sos_idx=2, eos_idx=3)
    got = pbs.captions_from_result(pbs.beam_search(model, TINY_CAP, cross, pcfg_, noise=noise))
    assert got[0] == want[0]
    greedy = pbs.captions_from_result(pbs.beam_search(
        model, TINY_CAP, cross, dataclasses.replace(pcfg_, sample_or_max="max")))
    assert greedy[0] != got[0]  # the noise did change the beams
    for g_img, w_img in zip(got[1], want[1]):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="noise of shape"):
        pbs.beam_search(model, TINY_CAP, cross, pcfg_, noise=[torch.zeros(3, v)])


@pytest.mark.parametrize("step_impl", pdc.STEP_IMPLS)
def test_ensemble_tokens_equal_jax_ensemble(step_impl):
    """Two models, the log of the mean of their probabilities each step:
    `ensemble_beam_search` and `EnsembleCaptioner` give the JAX package's
    tokens at fp32, with encoder pads."""
    pairs = [captioner_pair(TINY_CAP, s) for s in (0, 1)]
    jc = to_jax_cap(TINY_CAP)
    feats = np.random.default_rng(4).standard_normal(
        (2, 7, TINY_CAP.img_feature_dim)).astype(np.float32)
    pads = np.array([0, 2], np.int32)
    args = {"beam_size": 3, "how_many_outputs": 2, "beam_max_seq_len": 12}
    want = japi.EnsembleCaptioner(
        [japi.Captioner(p, jc, args) for p, _ in pairs])(feats, pads)
    ens = EnsembleCaptioner(
        [Captioner(m, TINY_CAP, args, device="cpu", step_impl=step_impl) for _, m in pairs])
    got = ens(feats, pads)
    assert got[0] == want[0]
    for g_img, w_img in zip(got[1], want[1]):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    single = Captioner(pairs[0][1], TINY_CAP, args, device="cpu")(feats, enc_x_num_pads=pads)
    assert single[0] != got[0]  # the second model did change the captions
    with pytest.raises(ValueError, match="only beam search"):
        ens(feats, pads, mode="sampling")
    with pytest.raises(ValueError, match="at least one"):
        EnsembleCaptioner([])


def test_features_in_captioner_matches_jax_api():
    """`Captioner` over the caption head alone (features in, `enc_x_num_pads`)
    against the JAX `api.Captioner`: encoder output, beam tokens, and the
    sampling mode's shapes."""
    params, model = captioner_pair(TINY_CAP, 2)
    jc = to_jax_cap(TINY_CAP)
    feats = np.random.default_rng(3).standard_normal(
        (3, 8, TINY_CAP.img_feature_dim)).astype(np.float32)
    pads = np.array([0, 1, 3], np.int32)
    args = {"beam_size": 2, "how_many_outputs": 2, "beam_max_seq_len": 10,
            "sample_max_seq_len": 6}
    ref = japi.Captioner(params, jc, args)
    port = Captioner(model, TINY_CAP, args, device="cpu")
    assert not port.end_to_end and port.dtype is None
    np.testing.assert_allclose(
        port.forward_enc(feats, pads).numpy(), np.asarray(ref.forward_enc(feats, pads)),
        rtol=1e-4, atol=1e-4)
    want_caps, _ = ref(feats, enc_x_num_pads=pads, mode="beam_search")
    got_caps, _ = port(feats, enc_x_num_pads=pads, mode="beam_search")
    assert got_caps == want_caps
    caps, lps = port(feats, enc_x_num_pads=pads, mode="sampling",
                     generator=torch.Generator().manual_seed(0))
    want_s, want_lps = ref(feats, enc_x_num_pads=pads, mode="sampling",
                           rng=jax.random.PRNGKey(0))
    assert len(caps) == len(want_s) == 3 and len(caps[0]) == len(want_s[0]) == 2
    assert tuple(lps.shape) == tuple(want_lps.shape) == (3, 2, 7)
    with pytest.raises(ValueError, match="unknown mode"):
        port(feats, enc_x_num_pads=pads, mode="???")
    with pytest.raises(ValueError, match="step_impl"):
        Captioner(model, TINY_CAP, args, device="cpu", step_impl="xla")
