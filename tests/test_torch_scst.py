"""The port's SCST training and features-in forward against the JAX package on
the CPU: `ExpansionNetV2.forward`, the features-in XE step, the two-phase
`make_scst_step` and the shared-encoder `make_scst_fused_step`, for the
caption head over features and for the end-to-end model (the JAX backbone on
its Pallas training kernels in interpret mode, as `tests/test_torch_train.py`
runs it); then the port's own invariants, mirrors of the JAX package's
`tests/test_learning.py` SCST tests.

Inputs come from numpy with a seed. The JAX steps run with an optimizer that
notes the gradients it is handed (the port's steps take a torch optimizer),
so gradients are compared, not updated parameters. Where sampling enters, the
port is handed the Gumbel noise the JAX key chain draws (`_gumbel_chain`).
Tolerances: the forward 2e-5 relative to the tensor's max (fp32 through the
caption stacks); losses, metrics and every gradient 1e-4 relative to each
tensor's max (`STACK_TOL`, with the floor of `assert_all_close_to_max`).
Sampled tokens are compared exactly.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.data import text as ptext
from on_device_image_captioning_torch.decode import sampling as psmp
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2, init_weights
from on_device_image_captioning_torch.train import device_cider as pdev
from on_device_image_captioning_torch.train import radam as pradam
from on_device_image_captioning_torch.train import train_step as pstep
from on_device_image_captioning_torch.utils import profiling
from on_device_image_captioning_tpu.data import text as jtext
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.params.torch_convert import (
    convert_captioner,
    convert_end_to_end,
)
from on_device_image_captioning_tpu.train import device_cider as jdev
from on_device_image_captioning_tpu.train import radam as jradam
from on_device_image_captioning_tpu.train import train_step as jstep

from test_torch_harness import TINY_CAP, TINY_SWIN, captioner_pair, to_jax_cap
from test_torch_slice3 import _gumbel_chain
from test_torch_train import (
    STACK_TOL,
    _compare_trees,
    _tree_grads,
    _xe_pair,
    assert_close_to_max,
)

FWD_TOL = 2e-5
N_OUT, L = 3, 8
# an EOS id these weights sample early (rows of both lengths)
CAP = dataclasses.replace(TINY_CAP, eos_idx=7)
METRICS = ("loss", "reward", "baseline", "logprob_sum")


def _features(seed, b=2, s=6):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, s, CAP.img_feature_dim)).astype(np.float32)
    pads = np.array([0, 2] + [1] * (b - 2), np.int32)[:b]
    return feats, pads


def _noting(inner):
    """An optax transformation that notes the gradients it is handed (popped
    from the same trace) and then updates as `inner` does."""
    seen = []

    def update(grads, state, params_):
        seen.append(grads)
        return inner.update(grads, state, params_)

    return optax.GradientTransformation(inner.init, update), seen


def _grads_like_jax(model, kind, jc):
    if kind == "features":
        return _tree_grads(model, convert_captioner, jc)
    return _tree_grads(model, convert_end_to_end, jc)


# ---------------------------------------------------------------------------
# the features-in forward and XE step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("log_softmax", [False, True])
def test_captioner_forward_matches_jax(padded, log_softmax):
    params, model = captioner_pair(CAP, 1)
    jc = to_jax_cap(CAP)
    feats, pads = _features(2, b=3, s=7)
    rng = np.random.default_rng(3)
    dec = rng.integers(4, CAP.vocab_size, (3, 6)).astype(np.int32)
    dec[:, 0] = CAP.sos_idx
    dec_pads = np.array([0, 1, 3], np.int32)
    enc_pads = np.array([0, 2, 4], np.int32) if padded else None
    want = jcap.forward(params, jc, jnp.asarray(feats), jnp.asarray(dec),
                        enc_num_pads=None if enc_pads is None else jnp.asarray(enc_pads),
                        dec_num_pads=jnp.asarray(dec_pads), apply_log_softmax=log_softmax)
    got = model(torch.from_numpy(feats), torch.from_numpy(dec),
                None if enc_pads is None else torch.from_numpy(enc_pads),
                torch.from_numpy(dec_pads), apply_log_softmax=log_softmax)
    assert got.shape == (3, 6, CAP.vocab_size) and got.dtype == torch.float32
    assert_close_to_max(got, want, FWD_TOL, "logits")
    # the training forward without a generator is the same function
    with torch.no_grad():
        again = model(torch.from_numpy(feats), torch.from_numpy(dec),
                      None if enc_pads is None else torch.from_numpy(enc_pads),
                      torch.from_numpy(dec_pads), train=True, apply_log_softmax=log_softmax)
    assert torch.equal(again, got.detach())


def test_captioner_forward_dropout_and_dtype():
    """A generator draws the dropouts (rates of `cfg.drop`) when training;
    dtype=bfloat16 computes the products in bf16 and still log-softmaxes in
    fp32."""
    cfg = dataclasses.replace(CAP, drop=pcfg.DropConfig(0.2, 0.2, 0.2, 0.2, 0.2))
    _, model = captioner_pair(cfg, 1)
    feats, pads = _features(4)
    dec = torch.tensor([[2, 9, 11, 5], [2, 30, 7, 0]])
    x = torch.from_numpy(feats)
    base = model(x, dec, torch.from_numpy(pads), apply_log_softmax=True)
    noisy = model(x, dec, torch.from_numpy(pads), train=True,
                  generator=torch.Generator().manual_seed(0), apply_log_softmax=True)
    same = model(x, dec, torch.from_numpy(pads), train=True,
                 generator=torch.Generator().manual_seed(0), apply_log_softmax=True)
    assert torch.equal(noisy, same) and not torch.allclose(noisy, base)
    half = model(x, dec, torch.from_numpy(pads), apply_log_softmax=True, dtype=torch.bfloat16)
    assert half.dtype == torch.float32
    assert_close_to_max(half, base, 3e-2, "bf16 log-probs")


def test_features_xe_step_matches_jax():
    """Loss and every gradient of the features-in XE step (`make_xe_step`
    over a caption head with a CaptionerConfig, enc_num_pads from the batch)
    against the JAX package's `make_xe_step(end_to_end_model=False)`."""
    params, model = captioner_pair(CAP, 3)
    jc = to_jax_cap(CAP)
    feats, pads = _features(5)
    rng = np.random.default_rng(6)
    captions = rng.integers(4, CAP.vocab_size, (2, 9)).astype(np.int32)
    captions[:, 0] = CAP.sos_idx
    captions[1, 6:] = CAP.pad_idx
    lr = 1e-2
    optimizer, seen = _noting(jradam.plain_radam(lr))
    state = jstep.init_train_state(params, optimizer)
    xe = jstep.make_xe_step(jc, optimizer, False)
    batch = {"enc_input": jnp.asarray(feats), "captions": jnp.asarray(captions),
             "enc_num_pads": jnp.asarray(pads)}
    _, metrics, want_grads = jax.jit(lambda st, ba: (*xe(st, ba, None), seen.pop()))(state, batch)

    pbatch = {"enc_input": torch.from_numpy(feats), "captions": torch.from_numpy(captions),
              "enc_num_pads": torch.from_numpy(pads)}
    step = pstep.make_xe_step(model, CAP, pradam.PlainRAdam(model.parameters(), lr))
    out = step(pbatch)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=STACK_TOL)
    _compare_trees(_grads_like_jax(model, "features", jc), want_grads, STACK_TOL)
    with pytest.raises(ValueError, match="no backbone"):
        pstep.xe_loss(model, CAP, pbatch, drop_path_scales=[])


# ---------------------------------------------------------------------------
# the two-phase SCST step
# ---------------------------------------------------------------------------


def _sampled_tokens(seed, b, vocab, eos):
    """(B, N_OUT, L+1) tokens with SOS, EOS at `lengths` (one row runs to L
    without one), arbitrary ids after it, as a sampler leaves them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, vocab, (b, N_OUT, L + 1)).astype(np.int32)
    toks[toks == eos] = eos + 1
    toks[:, :, 0] = 2
    lengths = rng.integers(1, L + 1, (b, N_OUT)).astype(np.int32)
    lengths[0, 0], lengths[-1, -1] = 1, L  # EOS at once; no EOS at all
    for i in range(b):
        for j in range(N_OUT):
            if lengths[i, j] < L or (i, j) != (b - 1, N_OUT - 1):
                toks[i, j, lengths[i, j]] = eos
    rewards = rng.random((b, N_OUT)).astype(np.float32)
    return toks, lengths, rewards


def _pair(kind, seed):
    """(port cfg, JAX cfg, JAX params, port model, JAX batch, port batch)."""
    if kind == "features":
        params, model = captioner_pair(CAP, seed)
        feats, pads = _features(seed + 1)
        return (CAP, to_jax_cap(CAP), params, model,
                {"enc_input": jnp.asarray(feats), "enc_num_pads": jnp.asarray(pads)},
                {"enc_input": torch.from_numpy(feats), "enc_num_pads": torch.from_numpy(pads)})
    cfg, jc, params, model, images, _ = _xe_pair(seed)
    return (cfg, jc, params, model, {"enc_input": jnp.asarray(images)},
            {"enc_input": torch.from_numpy(images)})


@pytest.mark.parametrize("kind", ["features", "end_to_end"])
def test_scst_step_matches_jax(kind):
    """Loss, the three metrics and every gradient of `make_scst_step` on the
    same tokens, lengths (rows that end at once, rows with no EOS) and
    rewards: the encoder re-run with train=True, the decoder re-score, the
    log-probs kept up to and including EOS."""
    cfg, jc, params, model, jbatch, pbatch = _pair(kind, 7)
    cap = cfg if kind == "features" else cfg.captioner
    toks, lengths, rewards = _sampled_tokens(8, 2, cap.vocab_size, cap.eos_idx)
    optimizer, seen = _noting(optax.sgd(1e-3))
    state = jstep.init_train_state(params, optimizer)
    scst = jstep.make_scst_step(jc, optimizer, kind != "features", N_OUT)
    sampled = {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)}
    _, metrics, want_grads = jax.jit(
        lambda st, ba, sa, r: (*scst(st, ba, sa, r), seen.pop()))(
        state, jbatch, sampled, jnp.asarray(rewards))

    step = pstep.make_scst_step(model, cfg, torch.optim.SGD(model.parameters(), lr=1e-3), N_OUT)
    out = step(pbatch, {"tokens": torch.from_numpy(toks), "lengths": torch.from_numpy(lengths)},
               rewards)  # numpy rewards, as CiderReward returns them
    for key in METRICS:
        np.testing.assert_allclose(float(out[key]), float(metrics[key]), rtol=STACK_TOL,
                                   atol=1e-6, err_msg=key)
    _compare_trees(_grads_like_jax(model, kind, jc), want_grads, STACK_TOL)
    with pytest.raises(ValueError, match="samples an image"):
        step(pbatch, {"tokens": torch.from_numpy(toks[:, :2]),
                      "lengths": torch.from_numpy(lengths[:, :2])}, rewards[:, :2])


# ---------------------------------------------------------------------------
# the shared-encoder SCST step
# ---------------------------------------------------------------------------


def _words_vocab(mod, size, eos):
    """A vocabulary of `size` words with the model's special ids."""
    words = [f"w{i}" for i in range(size)]
    words[0], words[1], words[2], words[eos] = (mod.PAD_TOKEN, mod.UNK_TOKEN, mod.SOS_TOKEN,
                                                mod.EOS_TOKEN)
    return mod.Vocab({w: i for i, w in enumerate(words)})


def _rewards(kind, size, eos, refs_seed=0):
    """(JAX reward_fn, port reward_fn, JAX ref tables, port ref tables) of
    one kind: 'cider' (the device CIDEr-D on a random corpus) or 'tokens'
    (an integer function of the tokens)."""
    if kind == "tokens":
        def jfn(tokens, lengths, tables):
            return (tokens[:, :, 1:].sum(-1) % 5).astype(jnp.float32) - 2.0

        def pfn(tokens, lengths, tables):
            return (tokens[:, :, 1:].long().sum(-1) % 5).float() - 2.0

        return jfn, pfn, None, None
    rng = np.random.default_rng(refs_seed)
    pv, jv = _words_vocab(ptext, size, eos), _words_vocab(jtext, size, eos)
    words = [w for w in pv.idx2word if w.startswith("w")]
    refs = [[" ".join(rng.choice(words, int(rng.integers(2, 9)))) for _ in range(3)]
            for _ in range(5)]
    jc, pc = jdev.DeviceCiderCorpus(refs, jv), pdev.DeviceCiderCorpus(refs, pv)
    idx = np.array([1, 4])
    return (jc.make_reward_fn(), pc.make_reward_fn("cpu"),
            {k: jnp.asarray(v) for k, v in jc.batch(idx).items()}, pc.batch(idx))


@pytest.mark.parametrize("kind, reward", [
    ("features", "tokens"), ("features", "cider"), ("end_to_end", "cider")])
def test_scst_fused_step_matches_jax(kind, reward):
    """With the Gumbel noise of the JAX key chain handed in: the JAX tokens
    and lengths exactly, its rewards (exactly for an integer reward, within
    1e-5 for the CIDEr-D), then loss, metrics and every gradient."""
    cfg, jc, params, model, jbatch, pbatch = _pair(kind, 11)
    cap = cfg if kind == "features" else cfg.captioner
    jfn, pfn, jtables, ptables = _rewards(reward, cap.vocab_size, cap.eos_idx)
    captured = []

    def noting_reward(tokens, lengths, tables):
        r = jfn(tokens, lengths, tables)
        captured.append((tokens, lengths, r))
        return r

    optimizer, seen = _noting(optax.sgd(1e-3))
    state = jstep.init_train_state(params, optimizer)
    fused = jstep.make_scst_fused_step(jc, optimizer, kind != "features", N_OUT, L,
                                       cap.sos_idx, cap.eos_idx, noting_reward)
    key = jax.random.PRNGKey(13)
    _, metrics, (w_toks, w_lens, w_rewards), want_grads = jax.jit(
        lambda st, ba, t, k: (*fused(st, ba, t, k), captured.pop(), seen.pop()))(
        state, jbatch, jtables, key)

    b = pbatch["enc_input"].shape[0]
    noise = _gumbel_chain(key, [(b * N_OUT, cap.vocab_size)] * L)
    step = pstep.make_scst_fused_step(model, cfg, torch.optim.SGD(model.parameters(), lr=1e-3),
                                      N_OUT, L, cap.sos_idx, cap.eos_idx, pfn)
    out = step(pbatch, ptables, noise=noise)
    got = out["sampled"]
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(w_lens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(w_toks))
    if kind == "features":
        assert (got.lengths.numpy() < L).any()  # rows that sampled EOS early
    if reward == "tokens":
        np.testing.assert_array_equal(out["rewards"].numpy(), np.asarray(w_rewards))
    else:
        np.testing.assert_allclose(out["rewards"].numpy(), np.asarray(w_rewards), rtol=1e-5,
                                   atol=1e-5)
        assert float(out["rewards"].abs().max()) > 0
    for k in METRICS:
        np.testing.assert_allclose(float(out[k]), float(metrics[k]), rtol=STACK_TOL, atol=1e-6,
                                   err_msg=k)
    _compare_trees(_grads_like_jax(model, kind, jc), want_grads, STACK_TOL)


# ---------------------------------------------------------------------------
# the port's own invariants (mirrors of tests/test_learning.py)
# ---------------------------------------------------------------------------


def _dropout_model(seed):
    cfg = dataclasses.replace(CAP, drop=pcfg.DropConfig(0.3, 0.3, 0.2, 0.2, 0.1))
    _, model = captioner_pair(cfg, seed)
    return cfg, model


def test_scst_rescore_reproduces_sampling_logprobs():
    """Without a generator the re-score grades the sampled captions under the
    policy that produced them (nonzero dropout rates in the config): its
    per-caption log-prob sums equal the sampler's. A generator draws dropout
    for the re-score, and the sums move."""
    cfg, model = _dropout_model(5)
    feats, pads = _features(9, b=3)
    batch = {"enc_input": torch.from_numpy(feats), "enc_num_pads": torch.from_numpy(pads)}
    with torch.no_grad():
        enc = model.forward_enc(batch["enc_input"], batch["enc_num_pads"])
    sampled = psmp.sample(model, cfg, enc, 4, L, cfg.sos_idx, cfg.eos_idx,
                          enc_num_pads=batch["enc_num_pads"],
                          generator=torch.Generator().manual_seed(9))
    assert (sampled.lengths < L).any()
    rewards = torch.from_numpy(np.random.default_rng(5).random((3, 4)).astype(np.float32))
    step = pstep.make_scst_step(model, cfg, torch.optim.SGD(model.parameters(), lr=0.0), 4)
    want = float(sampled.logprobs.sum(-1).mean())
    tokens = {"tokens": sampled.tokens, "lengths": sampled.lengths}
    got = step(batch, tokens, rewards)
    np.testing.assert_allclose(float(got["logprob_sum"]), want, rtol=2e-5, atol=2e-5)
    noisy = step(batch, tokens, rewards, torch.Generator().manual_seed(3))
    assert abs(float(noisy["logprob_sum"]) - want) > 1e-3


@pytest.mark.parametrize("step_impl", ["pallas", "pallas_fused"])
def test_scst_fused_step_matches_two_phase(step_impl):
    """The shared-encoder step is the same estimator as sampling, then the
    two-phase step, with dropout off: the same tokens, rewards and metrics,
    the same gradients and the same parameters after a PlainRAdam step; with
    either decode step in the sampler."""
    cfg, base = _dropout_model(4)
    feats, pads = _features(10, b=3)
    batch = {"enc_input": torch.from_numpy(feats), "enc_num_pads": torch.from_numpy(pads)}
    _, pfn, _, _ = _rewards("tokens", cfg.vocab_size, cfg.eos_idx)
    noise = [torch.from_numpy(np.random.default_rng(20 + t).gumbel(size=(12, cfg.vocab_size))
                              .astype(np.float32)) for t in range(L)]
    fused_model, two_model = copy.deepcopy(base), copy.deepcopy(base)
    fused = pstep.make_scst_fused_step(
        fused_model, cfg, pradam.PlainRAdam(fused_model.parameters(), 1e-2), 4, L,
        cfg.sos_idx, cfg.eos_idx, pfn, step_impl=step_impl)
    out_f = fused(batch, None, noise=noise)

    with torch.no_grad():
        enc = two_model.forward_enc(batch["enc_input"], batch["enc_num_pads"], train=True)
    sampled = psmp.sample(two_model, cfg, enc, 4, L, cfg.sos_idx, cfg.eos_idx,
                          enc_num_pads=batch["enc_num_pads"], step_impl=step_impl, noise=noise)
    rewards = pfn(sampled.tokens, sampled.lengths, None)
    two = pstep.make_scst_step(two_model, cfg, pradam.PlainRAdam(two_model.parameters(), 1e-2), 4)
    out_t = two(batch, {"tokens": sampled.tokens, "lengths": sampled.lengths}, rewards)

    assert torch.equal(out_f["sampled"].tokens, sampled.tokens)
    assert torch.equal(out_f["rewards"], rewards)
    for k in METRICS:
        np.testing.assert_allclose(float(out_f[k]), float(out_t[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for (name, a), b in zip(fused_model.named_parameters(), two_model.parameters()):
        assert_close_to_max(a.grad, b.grad, 1e-5, name, floor=1e-9)
        assert_close_to_max(a.detach(), b.detach(), 1e-6, name)


def test_scst_fused_step_runs_the_encoder_once_and_shares_its_dropout():
    """dropout=True: the encoder forward runs once a step (the sampler and the
    gradient share its draw) and the re-score takes an independent draw, so
    the re-scored log-probs leave the sampler's; dropout=False keeps them."""
    cfg, model = _dropout_model(5)
    feats, pads = _features(11, b=2)
    batch = {"enc_input": torch.from_numpy(feats), "enc_num_pads": torch.from_numpy(pads)}
    calls = []
    real = model.forward_enc

    def counted(*args, **kwargs):
        calls.append(kwargs.get("train", args[3] if len(args) > 3 else False))
        return real(*args, **kwargs)

    model.forward_enc = counted
    _, pfn, _, _ = _rewards("tokens", cfg.vocab_size, cfg.eos_idx)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    for dropout, moved in ((False, False), (True, True)):
        step = pstep.make_scst_fused_step(model, cfg, opt, 3, L, cfg.sos_idx, cfg.eos_idx, pfn,
                                          dropout=dropout)
        calls.clear()
        out = step(batch, None, generator=torch.Generator().manual_seed(6))
        assert calls == [True]
        sampled_sum = float(out["sampled"].logprobs.sum(-1).mean())
        assert (abs(float(out["logprob_sum"]) - sampled_sum) > 1e-3) == moved, dropout
    with pytest.raises(ValueError, match="generator or the noise"):
        step(batch, None)


def test_scst_fused_step_end_to_end_trains_the_backbone():
    """Over the end-to-end model on uint8 images: every parameter, the
    backbone's included, gets a finite gradient through the shared forward,
    the backbone's nonzero, and the parameters move; the recorder holds the
    step's six part spans in order, inside its `scst` span."""
    swin = dataclasses.replace(TINY_SWIN, attention_impl="fused")
    cap = dataclasses.replace(TINY_CAP, vocab_size=64, img_feature_dim=swin.num_features,
                              N_enc=1, N_dec=1, num_exp_enc_list=(4,))
    cfg = pcfg.ModelConfig(swin=swin, captioner=cap)
    model = init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, pfn, _, _ = _rewards("tokens", cap.vocab_size, cap.eos_idx)
    step = pstep.make_scst_fused_step(model, cfg, pradam.PlainRAdam(model.parameters(), 1e-3),
                                      3, L, cap.sos_idx, cap.eos_idx, pfn)
    images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    profiling.clear()
    out = step({"enc_input": torch.from_numpy(images)}, None,
               generator=torch.Generator().manual_seed(5))
    recs = profiling.records()
    root = next(r for r in recs if r.name == "scst")
    parts = [r for r in recs if r.name.startswith("scst.")]
    assert [r.name for r in parts] == ["scst." + p for p in (
        "encoder", "sampling", "reward", "rescore", "backward", "optimizer")]
    assert all(r.parent == root.id for r in parts)
    assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
    assert np.isfinite(float(out["loss"])) and float(out["rewards"].std()) > 0
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
    swin_grads = [g for n, g in grads.items() if n.startswith("swin_transf.")]
    assert max(float(g.abs().max()) for g in swin_grads) > 0
    moved = [float((p.detach() - before[n]).abs().max()) for n, p in model.named_parameters()
             if n.startswith("swin_transf.")]
    assert max(moved) > 0
