"""The port's parameter and FLOP accounting (`deploy/analysis.py`) against the
JAX package's, as integers, on the Swin-L/384 + d512 configuration and on tiny
ones; mirrors tests/test_deploy.py::test_analysis_counts and
test_train_step_flops. `param_count` of a port model built from JAX
parameters by `params/convert.py` equals the JAX count of those parameters."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_tp_worker as w
from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.deploy import analysis as pa
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
from on_device_image_captioning_tpu.deploy import analysis as ja
from on_device_image_captioning_tpu.models import end_to_end as je2e
from on_device_image_captioning_tpu.models import swin as jswin
from test_torch_harness import TINY_CAP, TINY_E2E, captioner_pair, e2e_pair, to_jax_model

CONFIGS = {
    "swin_l_d512": pcfg.ModelConfig(),
    "tiny": TINY_E2E,
    "tiny_tp": w.TP_E2E,
    "tiny_one_stage_window": dataclasses.replace(
        TINY_E2E, swin=dataclasses.replace(TINY_E2E.swin, window_size=8),
        captioner=dataclasses.replace(TINY_E2E.captioner, N_enc=3, N_dec=1, ff=48)),
}


def _calls(cfg):
    """(name, port call, JAX call) of every counting function at a few
    arguments each."""
    jc = to_jax_model(cfg)
    s_enc = cfg.swin.stage_resolution(cfg.swin.num_layers - 1)[0] ** 2
    out = [("swin_flops", lambda m, c: m.swin_flops(c.swin))]
    for s in (s_enc, 7):
        out.append((f"encoder_flops s{s}", lambda m, c, s=s: m.encoder_flops(c.captioner, s)))
        for t in (1, 5, 20):
            out.append((f"decoder_flops_full_prefix t{t} s{s}",
                        lambda m, c, t=t, s=s: m.decoder_flops_full_prefix(c.captioner, t, s)))
            out.append((f"decoder_flops_incremental_step t{t} s{s}",
                        lambda m, c, t=t, s=s: m.decoder_flops_incremental_step(
                            c.captioner, t, s)))
    for remat in (True, False):
        out.append((f"xe_train_step_flops remat={remat}",
                    lambda m, c, r=remat: m.xe_train_step_flops(c, 28, remat=r)))
        out.append((f"scst_train_step_flops remat={remat}",
                    lambda m, c, r=remat: m.scst_train_step_flops(c, 20, 5, remat=r)))
    for beam, inc in ((3, True), (5, True), (5, False)):
        out.append((f"beam_search_flops b{beam} incremental={inc}",
                    lambda m, c, b=beam, i=inc: m.beam_search_flops(c, b, 20, incremental=i)))
    return [(name, fn(pa, cfg), fn(ja, jc)) for name, fn in out]


@pytest.mark.parametrize("which", list(CONFIGS))
def test_counts_equal_jax_as_integers(which):
    calls = _calls(CONFIGS[which])
    assert len(calls) == 22
    for name, got, want in calls:
        assert type(got) is type(want), name
        if isinstance(want, dict):
            assert all(type(v) is int for v in got.values()), name
        else:
            assert type(got) is int, name
        assert got == want, (which, name)


@pytest.mark.parametrize("which", list(CONFIGS))
def test_effective_window_equals_jax(which):
    cfg = CONFIGS[which].swin
    jc = to_jax_model(CONFIGS[which]).swin
    from on_device_image_captioning_torch.models.swin import effective_window

    for stage in range(cfg.num_layers):
        for block in range(cfg.depths[stage]):
            assert effective_window(cfg, stage, block) == jswin.effective_window(jc, stage, block)


@pytest.mark.parametrize("what", ["captioner", "end_to_end"])
def test_param_count_of_converted_model_equals_jax(what):
    if what == "captioner":
        params, model = captioner_pair(TINY_CAP, 0)
    else:
        params, model = e2e_pair(TINY_E2E, 1)
    want = ja.param_count(params)
    assert pa.param_count(model) == want
    assert pa.param_count(model.state_dict()) == want


def test_param_count_at_full_size_equals_jax_tree():
    """Swin-L/384 + d512 on the meta device against the JAX tree's shapes."""
    cfg = pcfg.ModelConfig()
    with torch.device("meta"):
        model = EndExpansionNetV2(cfg)
    shapes = jax.eval_shape(lambda: je2e.init(jax.random.PRNGKey(0), to_jax_model(cfg)))
    want = int(sum(np.prod(x.shape) for x in jax.tree.leaves(shapes)))
    assert pa.param_count(model) == want
    assert 2.0e8 < want < 2.6e8


def test_analysis_counts_mirror():
    """tests/test_deploy.py::test_analysis_counts on the port."""
    full = pcfg.ModelConfig()
    flops = pa.beam_search_flops(full, beam=5, steps=20)
    ref_strategy = pa.beam_search_flops(full, beam=5, steps=20, incremental=False)
    assert flops["total"] < ref_strategy["total"]
    assert 0.5e11 < ref_strategy["total"] < 3e11


def test_train_step_flops_mirror():
    """tests/test_deploy.py::test_train_step_flops on the port."""
    full = pcfg.ModelConfig()
    xe = pa.xe_train_step_flops(full, seq_len=28, remat=True)
    xe_nr = pa.xe_train_step_flops(full, seq_len=28, remat=False)
    assert xe["total"] - xe_nr["total"] == xe["backbone_fwd"]
    assert xe["backbone_train"] == 4 * xe["backbone_fwd"]
    assert 4.0e11 < xe["total"] < 4.6e11
    scst = pa.scst_train_step_flops(full, scst_len=20, num_samples=5)
    assert scst["total"] > scst["encoder_fwd"] * 3
    assert 2.5e11 < scst["total"] < 4.5e11
