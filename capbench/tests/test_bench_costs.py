"""The frozen cost table equals the program's own accounting
(`deploy/analysis.py`) at the cells' shapes, and its bounds are sane."""

import pytest

from capbench import costs
from capbench.manifest import Manifest
from capbench.program import model_config


@pytest.fixture(scope="module")
def cfgs():
    m = Manifest()
    return {c["name"]: m.config(c["name"]) for c in m.data["configs"]}


def test_swin_and_encoder(cfgs):
    from on_device_image_captioning_torch.deploy import analysis

    for cfg in cfgs.values():
        mc = model_config(cfg)
        assert costs.swin_macs(cfg["swin"]) == analysis.swin_flops(mc.swin)
        assert costs.encoder_macs(cfg["captioner"], 144) == analysis.encoder_flops(
            mc.captioner, 144)


@pytest.mark.parametrize("steps", [19, 20])
def test_beam_search(cfgs, steps):
    from on_device_image_captioning_torch.deploy import analysis

    cfg = cfgs["expv2_swinL384_serve_bf16"]
    assert costs.beam_search_macs(cfg, 3, steps) == analysis.beam_search_flops(
        model_config(cfg), 3, steps)


@pytest.mark.parametrize("seq_len", [7, 12, 21])
def test_xe_step_without_remat(cfgs, seq_len):
    from on_device_image_captioning_torch.deploy import analysis

    cfg = cfgs["expv2_swinL384_xe_bf16"]
    assert costs.xe_step_macs(cfg, seq_len) == analysis.xe_train_step_flops(
        model_config(cfg), seq_len, remat=False)


def test_flops_per_image(cfgs):
    """FLOPs are 2 x MACs: 216.5 GFLOP an image for beam 3 over 20 steps."""
    total = costs.beam_search_macs(cfgs["expv2_swinL384_serve_bf16"], 3, 20)["total"]
    assert 2 * total == pytest.approx(216.5e9, rel=2e-3)


def test_bounds_are_below_the_flop_time(cfgs):
    """Each function's least time is at least its FLOP time at peak."""
    cfg = cfgs["expv2_swinL384_serve_bf16"]
    fns = costs.serve_request_functions(cfg, 32, 3, 20)
    macs = sum(m for m, _ in fns)
    assert costs.bound_s(fns) >= 2 * macs / costs.PEAK_BF16_FLOPS
    # the functions run the first decode step on one row an image, the
    # analysis on every beam: the counts differ by that step alone
    first_step = 2 * 32 * costs.decoder_step_macs(cfg["captioner"], 1, 144)
    assert macs + first_step == 32 * costs.beam_search_macs(cfg, 3, 19)["total"]


def test_param_count_is_close_to_the_model(cfgs):
    from on_device_image_captioning_torch.deploy import analysis
    from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
    import torch

    cfg = cfgs["expv2_swinL384_serve_bf16"]
    with torch.device("meta"):
        model = EndExpansionNetV2(model_config(cfg))
    assert costs.param_count(cfg) == pytest.approx(analysis.param_count(model), rel=3e-3)
