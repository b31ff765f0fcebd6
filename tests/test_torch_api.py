"""`api.Captioner`'s call is the JAX package's: `(enc_x, dec_x, enc_x_num_pads,
dec_x_num_pads, mode)`, with mode "forward" (the teacher-forced log-probs of
the prefix dec_x) and the public `forward_dec`. Held to the JAX
`api.Captioner` on the same weights and tokens, features-in and end to end,
at fp32: log-probs within 1e-5 of their max (fp32 sums in other orders).
Mirrors `tests/test_api.py`'s `test_mode_forward`,
`test_split_halves_consistent` and `test_captioner_end_to_end_model`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.api import Captioner
from on_device_image_captioning_tpu import api as japi

from test_torch_harness import (
    TINY_CAP,
    TINY_E2E,
    captioner_pair,
    e2e_pair,
    to_jax_cap,
    to_jax_model,
)


def _assert_within_max(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _tokens(rng, b, t, vocab):
    return rng.integers(0, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("dec_pads", [None, (0, 2)])
def test_mode_forward_features_in_equals_jax(dec_pads):
    """Positional arguments in the JAX order; the encoder pads shape the
    encoder output and, as in JAX, do not reach the decoder."""
    params, model = captioner_pair(TINY_CAP, 4)
    ref = japi.Captioner(params, to_jax_cap(TINY_CAP))
    port = Captioner(model, TINY_CAP, device="cpu")
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 7, TINY_CAP.img_feature_dim)).astype(np.float32)
    enc_pads = np.array([0, 3], np.int32)
    toks = _tokens(rng, 2, 5, TINY_CAP.vocab_size)
    pads = None if dec_pads is None else np.array(dec_pads, np.int32)
    want = ref(feats, toks, enc_pads, pads, mode="forward")
    got = port(feats, toks, enc_pads, pads, mode="forward")
    assert got.dtype == torch.float32 and got.shape == (2, 5, TINY_CAP.vocab_size)
    _assert_within_max(got.numpy(), want)
    np.testing.assert_allclose(torch.logsumexp(got[0, 0], dim=-1).item(), 0.0, atol=1e-5)


def test_forward_dec_is_the_second_half_of_mode_forward():
    """`forward_dec` over `forward_enc` equals mode "forward" and the JAX
    `forward_dec`, with and without the log-softmax."""
    params, model = captioner_pair(TINY_CAP, 5)
    ref = japi.Captioner(params, to_jax_cap(TINY_CAP))
    port = Captioner(model, TINY_CAP, device="cpu")
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 7, TINY_CAP.img_feature_dim)).astype(np.float32)
    toks = np.ones((2, 4), np.int32)
    cross = port.forward_enc(feats)
    split = port.forward_dec(cross, toks, apply_log_softmax=True)
    fused = port(feats, dec_x=toks, mode="forward")
    np.testing.assert_allclose(split.numpy(), fused.numpy(), atol=1e-6)
    jcross = ref.forward_enc(feats)
    _assert_within_max(split.numpy(), ref.forward_dec(jcross, toks, apply_log_softmax=True))
    logits = port.forward_dec(cross, toks, dec_num_pads=np.array([1, 0], np.int32))
    _assert_within_max(logits.numpy(), ref.forward_dec(jcross, toks, np.array([1, 0], np.int32)))


def test_mode_forward_end_to_end_equals_jax():
    """The end-to-end form on normalized float images, as the JAX call takes
    them; beam search and sampling still dispatch."""
    params, model = e2e_pair(TINY_E2E, 6)
    ref = japi.Captioner(params, to_jax_model(TINY_E2E))
    args = {"beam_size": 2, "beam_max_seq_len": 6, "sample_max_seq_len": 5}
    port = Captioner(model, TINY_E2E, args, device="cpu")
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    toks = _tokens(rng, 2, 4, TINY_E2E.captioner.vocab_size)
    want = ref(imgs, dec_x=toks, mode="forward")
    got = port(imgs, dec_x=toks, mode="forward")
    assert got.shape == (2, 4, TINY_E2E.captioner.vocab_size)
    _assert_within_max(got.numpy(), want)
    caps, _ = port(imgs, mode="beam_search")
    assert len(caps) == 2 and caps[0][0][0] == TINY_E2E.captioner.sos_idx
    caps, _ = port(imgs, mode="sampling", generator=torch.Generator().manual_seed(1))
    assert len(caps) == 2


def test_forward_dec_computes_in_the_model_dtype():
    """As JAX's: the end-to-end form's decoder computes in cfg.compute_dtype
    (bf16 here), the log-softmax in fp32."""
    cfg = dataclasses.replace(TINY_E2E, compute_dtype=torch.bfloat16)
    _, model = e2e_pair(cfg, 7)
    port = Captioner(model, cfg, device="cpu")
    imgs = np.random.default_rng(4).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    toks = np.array([[2, 5, 9]], np.int32)
    cross = port.forward_enc(imgs)
    got = port.forward_dec(cross, toks, apply_log_softmax=True)
    with torch.inference_mode():
        want = model.forward_dec(cross, torch.from_numpy(toks), None, None, True, torch.bfloat16)
        fp32 = model.forward_dec(cross, torch.from_numpy(toks), None, None, True, None)
    assert got.dtype == torch.float32
    assert torch.equal(got, want) and not torch.equal(got, fp32)
    assert torch.equal(port(imgs, toks, mode="forward"), got)
