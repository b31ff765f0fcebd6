"""The port's state_dict surgery (`params/surgery.py`) and `config.remove_layers`
against the JAX package's tree surgery: the port's operation on
`captioner_state_dict(jax_params)` must equal `captioner_state_dict` of the
JAX operation on `jax_params`, key for key and bit for bit."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.params import surgery as psurg
from on_device_image_captioning_torch.params.convert import captioner_state_dict, state_dict_from_jax
from on_device_image_captioning_tpu import config as jcfg
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.models import end_to_end as je2e
from on_device_image_captioning_tpu.params import surgery as jsurg

from test_torch_harness import TINY_CAP, TINY_E2E, numpy_tree, to_jax_cap, to_jax_model

CAP3 = dataclasses.replace(TINY_CAP, N_enc=3, N_dec=3)


def assert_same_sd(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("param_config", [0, 1, 2, 3])
def test_remove_layers_matches_jax(param_config):
    pm, jm = TINY_E2E, to_jax_model(TINY_E2E)
    pm = dataclasses.replace(pm, captioner=dataclasses.replace(pm.captioner, N_enc=3, N_dec=3))
    jm = dataclasses.replace(jm, captioner=dataclasses.replace(jm.captioner, N_enc=3, N_dec=3))
    if param_config == 3:
        with pytest.raises(ValueError, match="param_config"):
            pcfg.remove_layers(pm, 3)
        return
    got, want = pcfg.remove_layers(pm, param_config), jcfg.remove_layers(jm, param_config)
    assert (got.captioner.N_enc, got.captioner.N_dec) == (want.captioner.N_enc,
                                                          want.captioner.N_dec)
    assert got.swin == pm.swin


@pytest.mark.parametrize("param_config", [0, 1, 2])
def test_remove_layer_matches_jax(param_config):
    """Caption head of 3 + 3 layers: layer 1 dropped, layer 2 renumbered,
    the reduce_group weights sliced to their first and last chunks; the
    result loads strictly into the reduced model; the input is left as it
    was."""
    params = numpy_tree(jcap.captioner_init(jax.random.PRNGKey(0), to_jax_cap(CAP3)))
    sd = captioner_state_dict(params)
    kept = {k: v.clone() for k, v in sd.items()}
    got = psurg.remove_layer(sd, param_config)
    want = captioner_state_dict(numpy_tree(jsurg.remove_layer(params, param_config)))
    assert_same_sd(got, want)
    assert_same_sd(sd, kept)
    reduced = dataclasses.replace(CAP3, N_enc=3 - (param_config >= 1),
                                  N_dec=3 - (param_config >= 2))
    ExpansionNetV2(reduced).load_state_dict(got, strict=True)
    assert psurg.stack_depth(got, "encoders") == reduced.N_enc
    assert psurg.stack_depth(got, "decoders") == reduced.N_dec


def test_remove_layer_end_to_end_and_refusals():
    """In an end-to-end state_dict the backbone's keys pass untouched; a stack
    that is not 3 layers deep is refused, as in the JAX package."""
    cfg = dataclasses.replace(TINY_E2E, captioner=dataclasses.replace(
        TINY_E2E.captioner, N_enc=3, N_dec=3))
    params = numpy_tree(je2e.init(jax.random.PRNGKey(1), to_jax_model(cfg)))
    sd = state_dict_from_jax(params, cfg)
    got = psurg.remove_layer(sd, 2)
    want = state_dict_from_jax(
        {"swin": params["swin"], "captioner": jsurg.remove_layer(params["captioner"], 2)}, cfg)
    assert_same_sd(got, want)
    assert all(got[k] is sd[k] for k in sd if k.startswith("swin_transf."))
    two = captioner_state_dict(numpy_tree(jcap.captioner_init(jax.random.PRNGKey(2),
                                                              to_jax_cap(TINY_CAP))))
    with pytest.raises(ValueError, match="3-layer"):
        psurg.remove_layer(two, 1)
    with pytest.raises(AssertionError):
        jsurg.remove_layer(numpy_tree(jcap.captioner_init(jax.random.PRNGKey(2),
                                                          to_jax_cap(TINY_CAP))), 1)


@pytest.mark.parametrize("verbose", [False, True])
def test_partially_load_matches_jax(capsys, verbose):
    """Target 3 + 3 layers at vocab 50; source 2 + 2 layers at vocab 60 (its
    vocabulary-sized tensors of another shape, its third layers missing):
    every tensor of matching key and shape is the source's, the rest the
    target's; the same counts of found and missing."""
    tgt = numpy_tree(jcap.captioner_init(jax.random.PRNGKey(0), to_jax_cap(CAP3)))
    src_cfg = dataclasses.replace(TINY_CAP, vocab_size=60)
    src = numpy_tree(jcap.captioner_init(jax.random.PRNGKey(1), to_jax_cap(src_cfg)))
    got = psurg.partially_load(captioner_state_dict(tgt), captioner_state_dict(src), verbose)
    out_p = capsys.readouterr().out
    want = captioner_state_dict(numpy_tree(jsurg.partially_load(tgt, src, verbose)))
    out_j = capsys.readouterr().out
    assert_same_sd(got, want)
    if verbose:
        for word in ("Found: ", "Not found: "):
            assert out_p.count(word) == out_j.count(word) > 0
    src_sd = captioner_state_dict(src)
    assert torch.equal(got["encoders.0.ff.linear_1.weight"], src_sd["encoders.0.ff.linear_1.weight"])
    assert not torch.equal(got["vocab_linear.weight"][:50], src_sd["vocab_linear.weight"][:50])


def test_reinit_patch_embed_3x3():
    """A (192, 3, 3, 3) convolution kernel uniform within the JAX bound
    sqrt(6 / 27), a zero bias, drawn from the generator (same seed, same
    kernel); every other key untouched; the JAX version's (27, 192) matrix in
    the same bound is this kernel's layout."""
    params = numpy_tree(je2e.init(jax.random.PRNGKey(0), to_jax_model(TINY_E2E)))
    sd = state_dict_from_jax(params, TINY_E2E)
    prefix = "swin_transf."
    got = psurg.reinit_patch_embed_3x3(sd, torch.Generator().manual_seed(0), prefix=prefix)
    again = psurg.reinit_patch_embed_3x3(sd, torch.Generator().manual_seed(0), prefix=prefix)
    w, b = got[prefix + "patch_embed.proj.weight"], got[prefix + "patch_embed.proj.bias"]
    bound = math.sqrt(6.0 / 27)
    assert w.shape == (192, 3, 3, 3) and w.dtype == torch.float32
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert abs(float(w.mean())) < 0.05 * bound
    assert torch.equal(b, torch.zeros(192))
    assert torch.equal(w, again[prefix + "patch_embed.proj.weight"])
    changed = {prefix + "patch_embed.proj.weight", prefix + "patch_embed.proj.bias"}
    assert set(got) == set(sd)
    assert all(got[k] is sd[k] for k in sd if k not in changed)
    assert sd[prefix + "patch_embed.proj.weight"].shape == (16, 3, 4, 4)  # input untouched

    jax_out = jsurg.reinit_patch_embed_3x3(params["swin"], jax.random.PRNGKey(0))
    jw = np.asarray(jax_out["patch_embed"]["proj"]["w"])
    assert jw.shape == tuple(w.permute(2, 3, 1, 0).reshape(27, 192).shape)
    assert float(np.abs(jw).max()) <= bound
    np.testing.assert_array_equal(np.asarray(jax_out["patch_embed"]["proj"]["b"]), b.numpy())
