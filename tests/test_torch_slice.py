"""The slice end to end on the CPU: uint8 images -> `api.Captioner` beam
search in the port, against the JAX package's forward_enc + beam_search on its
Pallas kernels (interpret mode), same weights, TINY_E2E with vocab 1024 so the
JAX candidate stage reaches topk_pallas. At fp32 the tokens and lengths must
be equal, for three seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.api import Captioner
from on_device_image_captioning_tpu.config import DecodeConfig
from on_device_image_captioning_tpu.decode import beam_search as jbs
from on_device_image_captioning_tpu.models import end_to_end as je2e
from on_device_image_captioning_tpu.utils.image import normalize_on_device as jnormalize

from test_torch_harness import TINY_E2E, e2e_pair, jax_pallas_path, to_jax_model

BEAM, MAX_LEN, N_OUT = 3, 12, 2


def _jax_captions(params, cfg, imgs):
    jc = to_jax_model(cfg)
    cap = jc.captioner
    dcfg = DecodeConfig(
        beam_size=BEAM, how_many_outputs=N_OUT, max_seq_len=MAX_LEN,
        sos_idx=cap.sos_idx, eos_idx=cap.eos_idx, chunk_schedule=(MAX_LEN,),
    )

    @jax.jit
    def run(p, x):
        enc = je2e.forward_enc(p, jc, jnormalize(x))
        return jbs.beam_search(p["captioner"], cap, enc, dcfg, dtype=jc.compute_dtype)

    with jax_pallas_path():
        res = run(je2e.prepare_inference_params(params, jc), jnp.asarray(imgs))
    return jbs.captions_from_result(res)


# per seed, an EOS id these random weights emit a few tokens in, so beams
# finish at different steps and the EOS freeze and length ranking are exercised
@pytest.mark.parametrize("seed, eos", [(0, 553), (1, 75), (2, 13)])
def test_captioner_beam_search_tokens_equal_jax(seed, eos):
    cfg = dataclasses.replace(
        TINY_E2E, captioner=dataclasses.replace(TINY_E2E.captioner, eos_idx=eos)
    )
    params, model = e2e_pair(cfg, 10 + seed)
    imgs = np.random.default_rng(seed).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want_caps, want_lps = _jax_captions(params, cfg, imgs)
    captioner = Captioner(model, cfg, {
        "beam_size": BEAM, "how_many_outputs": N_OUT, "beam_max_seq_len": MAX_LEN,
    }, device="cpu")
    got_caps, got_lps = captioner(imgs, mode="beam_search")
    assert got_caps == want_caps  # tokens and lengths, exactly
    assert any(eos in toks for row in got_caps for toks in row)
    for g_img, w_img in zip(got_lps, want_lps):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)  # fp32 stack
    for row in got_caps:
        for toks in row:
            assert toks[0] == cfg.captioner.sos_idx
            assert 2 <= len(toks) <= MAX_LEN
            assert max(toks) < cfg.captioner.vocab_size


def test_captioner_bf16_runs_and_is_well_formed():
    """bf16 compute (caches in bf16): captions are well formed; bf16 parity
    with JAX holds only at the metric level, so tokens are not compared."""
    cfg = dataclasses.replace(TINY_E2E, compute_dtype=torch.bfloat16)
    _, model = e2e_pair(cfg, 20)
    imgs = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    caps, lps = Captioner(
        model, cfg, {"beam_size": BEAM, "beam_max_seq_len": MAX_LEN}, device="cpu")(imgs)
    assert len(caps) == 2
    for row, lp in zip(caps, lps):
        toks = row[0]
        assert toks[0] == cfg.captioner.sos_idx and 2 <= len(toks) <= MAX_LEN
        assert np.isfinite(lp[0]).all()


def test_captioner_rejects_unported_modes_and_mismatched_models():
    _, model = e2e_pair(TINY_E2E, 21)
    captioner = Captioner(model, TINY_E2E, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        captioner(np.zeros((1, 32, 32, 3), np.uint8), mode="sampling")
    with pytest.raises(ValueError):
        Captioner(model, TINY_E2E.captioner, device="cpu")


def test_demo_refuses_cuda_without_a_card(monkeypatch):
    from on_device_image_captioning_torch.cli import demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        demo.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):  # before any loading
        demo.main(["--load_path", "missing.pth", "--vocab_path", "missing.json",
                    "--image_paths", "missing.jpg"])
    assert demo.resolve_device("cpu").type == "cpu"
    with pytest.raises(SystemExit) as exit_info:
        demo.main(["--help"])
    assert exit_info.value.code == 0
