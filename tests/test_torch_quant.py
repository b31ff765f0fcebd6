"""Int8 quantized serving in the port against the JAX package on the CPU:
weight quantization and the encoder / decoder filters, B12's and B13's plain
versions against the JAX functions, the quantized backbone on the route the
JAX package takes, the quantized `api.Captioner`, calibration, the
straight-through estimator and `cli/quantize.py`.

Inputs come from numpy with a seed and go through the JAX function (its Pallas
kernels in interpret mode) and its counterpart in the port (on the CPU the
plain version of each kernel). Tolerances, each stated where it is used:
int8 values and scales are exact (the same IEEE divisions, round half to
even); an int8 product is an exact integer sum on both sides, so what differs
is an fp32 rounding of the epilogue or of a float product (1e-6 of the
output's max); through a model at fp32, summation order (1e-4); at bf16, a
value on the other side of a bf16 rounding boundary (2e-2).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.api import Captioner
from on_device_image_captioning_torch.cli import quantize as qcli
from on_device_image_captioning_torch.deploy import quantization as pq
from on_device_image_captioning_torch.models import swin as pswin
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
from on_device_image_captioning_torch.ops import quant_matmul as pqm
from on_device_image_captioning_torch.ops import swin_block_fused as psbf
from on_device_image_captioning_torch.params.convert import (
    captioner_state_dict,
    load_reference_state_dict,
    state_dict_from_jax,
)
from on_device_image_captioning_tpu.config import DecodeConfig
from on_device_image_captioning_tpu.decode import beam_search as jbs
from on_device_image_captioning_tpu.decode import cache as jdc
from on_device_image_captioning_tpu.deploy import quantization as jq
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.models import end_to_end as je2e
from on_device_image_captioning_tpu.models import swin as jswin
from on_device_image_captioning_tpu.ops import quant_matmul as jqm
from on_device_image_captioning_tpu.ops import swin_block_fused as jsbf
from on_device_image_captioning_tpu.utils.image import normalize_on_device as jnormalize

from test_torch_harness import (
    TINY_CAP, TINY_E2E, jax_pallas_path, numpy_tree, to_jax_cap, to_jax_model, to_jax_swin,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # through a model, relative to its max
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
FUSED_E2E = dataclasses.replace(
    TINY_E2E, swin=dataclasses.replace(TINY_E2E.swin, attention_impl="fused"))
# the tiny backbone with no single-window stage (grids of 4 x 4 and 2 x 2
# windows), where the JAX package's kernel gates pick the port's route
GRID_SWIN = dataclasses.replace(FUSED_E2E.swin, img_size=64)


def _jax_polynomial_gelu(t: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' GELU (`_gelu_exact` with the polynomial erf) on a torch
    tensor, to hand to the port's plain versions where a test must see the
    same int8 rounding as the JAX side."""
    out = np.array(jsbf._gelu_exact(jnp.asarray(t.detach().float().numpy())))
    return torch.from_numpy(out).to(t.dtype)


def _np32(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel_max(got, want) -> float:
    got, want = _np32(got), _np32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _quantized_pair(cfg, mode, seed, path_filter=None):
    """(quantized JAX tree, port model holding the same quantized weights)."""
    params = numpy_tree(je2e.init(jax.random.PRNGKey(seed), to_jax_model(cfg)))
    qp = jq.quantize_tree(params, mode, path_filter)
    model = EndExpansionNetV2(cfg)
    pq.load_quantized_state_dict(model, state_dict_from_jax(qp, cfg))
    return qp, model.eval()


def _jax_linear(rng, k, n, bias=True):
    node = {"w": (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)}
    if bias:
        node["b"] = (0.2 * rng.standard_normal(n)).astype(np.float32)
    return node


def _port_operands(node):
    """A quantized JAX node -> (w_q (out, in), scale, bias) of the port."""
    b = torch.from_numpy(np.asarray(node["b"])) if "b" in node else None
    return (torch.from_numpy(np.ascontiguousarray(np.asarray(node["w_q"]).T)),
            torch.from_numpy(np.asarray(node["scale"])), b)


# ---------------------------------------------------------------------------
# weights, filters, size, fake quantization
# ---------------------------------------------------------------------------


def test_quantize_weight_equals_jax():
    """w_q and scale bit for bit, a zero output channel (the 1e-8 floor) and
    exact half steps (round half to even) included."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0
    w[:5, 7] = [127.0, 0.5, -0.5, 1.5, 2.5]  # x / scale lands on .5 steps
    node = jq.quantize_linear({"w": w, "b": np.zeros(40, np.float32)}, "w8a8")
    w_q, scale = pq.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(w_q.numpy().T, node["w_q"])
    np.testing.assert_array_equal(scale.numpy(), node["scale"])


@pytest.mark.parametrize("which", ["all", "encoder", "decoder"])
def test_filters_select_the_jax_linears(which):
    """quantize_model / quantize_encoder / quantize_decoder quantize exactly the
    linears quantize_tree quantizes under the JAX patterns (names mapped
    through state_dict_from_jax), to the same values, and the parameter
    footprint agrees byte for byte."""
    cfg = TINY_E2E
    params = numpy_tree(je2e.init(jax.random.PRNGKey(1), to_jax_model(cfg)))
    jax_fn = {"all": lambda p: jq.quantize_tree(p, "w8a8"),
              "encoder": lambda p: jq.quantize_encoder(p, "w8a8"),
              "decoder": lambda p: jq.quantize_decoder(p, "w8a8")}[which]
    port_fn = {"all": lambda m: pq.quantize_model(m, "w8a8"),
               "encoder": lambda m: pq.quantize_encoder(m, "w8a8"),
               "decoder": lambda m: pq.quantize_decoder(m, "w8a8")}[which]
    qp = jax_fn(params)
    want = state_dict_from_jax(qp, cfg)
    model = EndExpansionNetV2(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg))
    got = port_fn(model).state_dict()
    assert {k for k in got if k.endswith(".w_q")} == {k for k in want if k.endswith(".w_q")}
    assert len([k for k in got if k.endswith(".w_q")]) > 10
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
        else:
            assert got[k] == v, k
    assert pq.quantized_size_bytes(model) == jq.quantized_size_bytes(qp)
    if which == "all":  # every linear, the patch-embed conv among them
        assert isinstance(model.swin_transf.patch_embed.proj, pq.QuantLinear)
        assert not any(isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) for m in model.modules())


def test_fake_quant_value_and_straight_through_gradient_match_jax():
    """As tests/test_deploy.py: the value is the int8 round trip, the gradient
    of sum(fake_quant(x)^2) is 2 fake_quant(x) (the identity passes through)."""
    x = np.linspace(-1, 1, 16, dtype=np.float32)
    x[3] = 0.37
    jg = jax.grad(lambda v: jnp.sum(jq.fake_quant(v) ** 2))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pq.fake_quant(xt)
    (y**2).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jq.fake_quant(jnp.asarray(x))))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# B12: the int8 product
# ---------------------------------------------------------------------------


def _matmul_inputs(k, bias, dtype, seed=0):
    rng = np.random.default_rng(seed)
    node = jq.quantize_linear(_jax_linear(rng, k, 48, bias), "w8a8")
    x = (rng.standard_normal((40, k)) * 1.7).astype(np.float32)
    return node, x, torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [64, 2080])  # 2080: above the fp32-exact limit of int8 sums
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_quantized_matmul_plain_matches_jax_model_function(dtype, k, static, bias):
    """B12's plain version against deploy/quantization.py::quantized_matmul,
    the function the JAX model runs (dynamic per-tensor scale in x's dtype, or
    a calibrated fp32 scale): the int8 x equal, the output within 1e-6 of its
    max."""
    node, x, xt = _matmul_inputs(k, bias, dtype)
    x_scale = None
    if static:
        node["x_scale"] = np.float32(1.3 * np.abs(x).max() / 127.0)
        x_scale = torch.tensor(node["x_scale"])
    want = np.asarray(jq.quantized_matmul(node, jnp.asarray(x).astype(JDT[dtype])))
    w_q, scale, b = _port_operands(node)
    xq = torch.empty(xt.shape, dtype=torch.int8)
    got = pqm.quantized_matmul(xt, w_q, scale, b, x_scale, xq_out=xq)
    assert got.dtype == torch.float32
    assert _rel_max(got, want) <= 1e-6
    jxs = node["x_scale"] if static else jnp.maximum(
        jnp.max(jnp.abs(jnp.asarray(x).astype(JDT[dtype]))), 1e-8) / 127.0
    jxq = jnp.clip(jnp.rint(jnp.asarray(x).astype(JDT[dtype]) / jxs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))


@pytest.mark.parametrize("k", [64, 2080])
def test_quantized_matmul_plain_matches_pallas_kernel_fp32(k):
    """Against the Pallas kernel B12 itself (interpret mode) at fp32, where the
    kernel and the model function agree: within 1e-6 of the output's max."""
    node, x, xt = _matmul_inputs(k, True, torch.float32, seed=1)
    want = np.asarray(jqm.quantized_matmul_pallas(
        jnp.asarray(x), jnp.asarray(node["w_q"]), jnp.asarray(node["scale"]),
        jnp.asarray(node["b"])))
    got = pqm.quantized_matmul(xt, *_port_operands(node))
    assert _rel_max(got, want) <= 1e-6


def test_pallas_kernel_differs_from_model_function_at_bf16():
    """A known difference of the reference, not of the port (ROADMAP §C): at
    bf16 the Pallas kernel divides the fp32 x by the bf16-rounded scale where
    the model's quantized_matmul divides in bf16, so the two JAX functions
    disagree; the port follows the model's function."""
    node, x, xt = _matmul_inputs(64, True, torch.bfloat16, seed=0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    model_fn = np.asarray(jq.quantized_matmul(node, xb))
    kernel = np.asarray(jqm.quantized_matmul_pallas(
        xb, jnp.asarray(node["w_q"]), jnp.asarray(node["scale"]), jnp.asarray(node["b"])))
    differ = float(np.mean(kernel != model_fn))
    rel_rms = float(np.sqrt(np.mean((kernel - model_fn) ** 2) / np.mean(model_fn**2)))
    assert differ > 0.9 and rel_rms > 1e-3, (differ, rel_rms)  # 0.998 and 7.5e-3 at seed 0
    got = pqm.quantized_matmul(xt, *_port_operands(node))
    assert _rel_max(got, model_fn) <= 1e-6


@pytest.mark.parametrize("m, route", [(1, "small"), (5, "small"), (24, "small"),
                                      (64, "small"), (65, "large"), (288, "large")])
def test_b12_route_by_rows(m, route):
    """B12's product takes the small-M route up to 64 rows (every decode
    call: 5 or 24 rows) and the large-M route above, by M alone; the small
    route's tile holds M rows without padding to 128."""
    assert pqm.product_route(m) == route
    plan = pqm.product_plan(m, 2048, 512)
    assert plan.route == route
    assert plan.tile_m >= m if route == "small" else plan.tile_m == 64
    assert plan.tile_m == 16 * plan.mt


# (M, N, K): decode at b1 / beam 5 and b8 / beam 3, the vocab, the cross K/V at
# b8, stage 3's fc1 at b2, the patch embed at b2, the CPU tests' K = 2080
@pytest.mark.parametrize("m, n, k", [(5, 2048, 512), (5, 512, 2048), (5, 10000, 512),
                                     (24, 512, 512), (24, 2048, 512), (24, 512, 2048),
                                     (1152, 512, 512), (288, 6144, 1536), (18432, 192, 48),
                                     (65, 64, 2080)])
def test_b12_product_plan_covers_the_product(m, n, k):
    """The tiles cover (M, N); the K slices are whole 64-value slabs that
    cover K with none empty; the small route splits K until about two CTAs an
    SM of an H100 (264) are in flight, where K allows it; the large route
    keeps K whole."""
    plan = pqm.product_plan(m, n, k)
    assert plan.tiles == (-(-m // plan.tile_m), -(-n // plan.tile_n))
    assert plan.k_per_split % pqm.K_SLAB == 0
    assert plan.splits * plan.k_per_split >= k > (plan.splits - 1) * plan.k_per_split
    ctas = plan.tiles[0] * plan.tiles[1] * plan.splits
    if plan.route == "small":
        assert plan.splits <= 16
        assert ctas >= 128 or plan.splits == -(-k // pqm.K_SLAB)
    else:
        assert plan.splits == 1


@pytest.mark.parametrize("numel, static, form, count", [
    (24 * 512, False, pqm.DYNAMIC_ONE_CTA, 1), (24 * 2048, False, pqm.DYNAMIC_ONE_CTA, 1),
    (288 * 1536, False, pqm.DYNAMIC_TWO_PASS, 2), (24 * 512, True, pqm.CALIBRATED, 1)])
def test_b12_quantize_form(numel, static, form, count):
    """The int8 x is formed once a call: by the calibrated scale in one
    launch, by a dynamic scale in one CTA for a decode-sized x, in two
    passes for a large one."""
    assert pqm.quantize_plan(numel, static) == form
    assert pqm.quantize_launch_count(numel, static) == count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static", [False, True])
def test_b12_parts_compose_to_the_plain_version(dtype, static):
    """The two parts' plain versions (int8 x and scale, then the product)
    give `quantized_matmul_reference` bit for bit, and the scale is the JAX
    model function's, IEEE division and bf16 rounding included."""
    node, x, xt = _matmul_inputs(2080, True, dtype, seed=3)
    x_scale = torch.tensor(np.float32(1.1 * np.abs(x).max() / 127.0)) if static else None
    w_q, scale, b = _port_operands(node)
    xq, s_x = pqm.quantize_activation_reference(xt, x_scale)
    assert s_x.dtype == torch.float32 and s_x.shape == (1,)
    got = pqm.int8_product_reference(xq, s_x, w_q, scale, b)
    assert torch.equal(got, pqm.quantized_matmul_reference(xt, w_q, scale, b, x_scale))
    if not static:
        jx = jnp.asarray(x).astype(JDT[dtype])
        want = jnp.maximum(jnp.max(jnp.abs(jx)), 1e-8) / 127.0
        assert s_x.item() == float(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8_linear_matches_jax(dtype):
    """Weight-only: x rounded to bf16, the bf16 dequantized weight, fp32 sums,
    and an fp32 output that is not rounded to bf16; within 1e-6 of its max."""
    rng = np.random.default_rng(2)
    node = jq.quantize_linear(_jax_linear(rng, 96, 64), "w8")
    x = rng.standard_normal((24, 96)).astype(np.float32)
    want = np.asarray(jq.quantized_matmul(node, jnp.asarray(x).astype(JDT[dtype])))
    layer = pq.QuantLinear(64, 96, True, "w8")
    w_q, scale, b = _port_operands(node)
    layer.w_q.copy_(w_q), layer.scale.copy_(scale), layer.bias.copy_(b)
    got = layer(torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32
    assert _rel_max(got, want) <= 1e-6
    assert bool((got != got.bfloat16().float()).any())  # not rounded to bf16


# ---------------------------------------------------------------------------
# B13: the int8 MLP half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, c, hidden", [(64, 32, 128), (256, 64, 256)])
def test_mlp_half_a8_plain_matches_jax_kernel(monkeypatch, dtype, rows, c, hidden):
    """B13's plain version against swin_mlp_half_fused on w8a8 nodes (the
    `_mlp_half_kernel_a8` Pallas kernel, interpret mode), at the shape of
    test_fused_mlp_half_a8_int8_accuracy and a stage-like one.

    The one intended difference is the GELU: the exact erf here, the TPU
    kernel's polynomial erf there (|err| <= 3e-7), which can move a hidden
    value across an int8 rounding boundary. So: (1) with the polynomial GELU
    handed to the plain version, the relative RMS of the difference is within
    1e-4 at fp32 and 1e-2 at bf16; (2) the exact erf changes at most 0.1% of
    the int8 hidden values, each by one step, which moves the output by at
    most 1e-3 of its RMS."""
    rng = np.random.default_rng(9)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    shift = (0.2 * rng.standard_normal(c)).astype(np.float32)
    fc1 = jq.quantize_linear(_jax_linear(rng, c, hidden), "w8a8")
    fc2 = jq.quantize_linear(_jax_linear(rng, hidden, c), "w8a8")
    p = {"norm2": {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
         "mlp": {"fc1": jax.tree.map(jnp.asarray, fc1), "fc2": jax.tree.map(jnp.asarray, fc2)}}
    x = rng.standard_normal((rows, c)).astype(np.float32)
    want = np.asarray(jsbf.swin_mlp_half_fused(jnp.asarray(x).astype(JDT[dtype]), p, 1e-5))
    want = want.astype(np.float32)
    args = (torch.from_numpy(x).to(dtype), (torch.from_numpy(scale), torch.from_numpy(shift)),
            _port_operands(fc1), _port_operands(fc2), 1e-5)

    def rel_rms(got):
        return float(np.sqrt(np.mean((_np32(got) - want) ** 2) / np.mean(want**2)))

    out, _, yq = psbf.swin_mlp_half_a8(*args, hidden=True)
    assert out.dtype == dtype and yq.dtype == torch.int8 and yq.shape == (rows, hidden)
    with monkeypatch.context() as m:
        m.setattr(psbf.F, "gelu", _jax_polynomial_gelu)
        out_poly, _, yq_poly = psbf.swin_mlp_half_a8(*args, hidden=True)
    assert rel_rms(out_poly) <= (1e-4 if dtype == torch.float32 else 1e-2)
    steps = (yq.int() - yq_poly.int()).abs()
    assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) <= 1e-3
    assert rel_rms(out) <= (1e-3 if dtype == torch.float32 else 1e-2)


# ---------------------------------------------------------------------------
# the quantized backbone and the slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_quantized_backbone_takes_the_jax_route(monkeypatch, mode, dtype):
    """The "fused" backbone with every linear quantized against swin_apply on
    the same tree: the boundaries plain (int8 products), each stage
    window-resident, w8a8 blocks on the halves with B13, w8 blocks on the whole
    block (tiny widths, as the JAX gates pick them); 1e-4 at fp32, 2e-2 at bf16
    of the output's max."""
    cfg = dataclasses.replace(FUSED_E2E, swin=GRID_SWIN, compute_dtype=dtype)
    qp, model = _quantized_pair(cfg, mode, 5)
    model.prepare_inference()
    calls = {"a8": 0, "dense": 0, "block": 0, "patch": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pswin, "swin_mlp_half_a8", spy("a8", pswin.swin_mlp_half_a8))
    monkeypatch.setattr(pswin, "swin_mlp_half", spy("dense", pswin.swin_mlp_half))
    monkeypatch.setattr(pswin, "swin_block", spy("block", pswin.swin_block))
    monkeypatch.setattr(pswin, "patch_embed_fused", spy("patch", pswin.patch_embed_fused))
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jswin.swin_apply(qp["swin"], to_jax_swin(cfg.swin), jnp.asarray(x), dtype=JDT[dtype])
    with torch.no_grad():
        got = model.swin_transf(torch.from_numpy(x), dtype)
    assert _rel_max(got, np.asarray(want).astype(np.float32)) <= TOL[dtype]
    blocks = sum(cfg.swin.depths)
    want_calls = {"a8": blocks, "dense": 0, "block": 0} if mode == "w8a8" else {
        "a8": 0, "dense": 0, "block": blocks}
    assert calls == {**want_calls, "patch": 0}
    assert model.swin_transf.stage_modes == {
        i: "halves" if mode == "w8a8" else "full" for i in range(2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_window_block_a8_matches_jax(dtype):
    """Swin-L stage 3's route at a tiny size: a single-window stage's plain
    block with w8a8 linears (per-tensor int8 through B12's plain version,
    fp32 activations after each product) against swin_block on the XLA path;
    1e-4 at fp32, 2e-2 at bf16 of the output's max."""
    cfg = dataclasses.replace(TINY_E2E.swin, attention_impl="fused")  # stage 1: one 4 x 4 window
    params = numpy_tree(jswin.swin_init(jax.random.PRNGKey(7), to_jax_swin(cfg, "xla")))
    qp = jq.quantize_tree(params, "w8a8")
    full = dataclasses.replace(FUSED_E2E, swin=cfg)
    model = EndExpansionNetV2(full)
    sd = state_dict_from_jax({"swin": qp, "captioner": numpy_tree(
        jcap.captioner_init(jax.random.PRNGKey(0), to_jax_cap(full.captioner)))}, full)
    pq.load_quantized_state_dict(model, sd)
    blk = model.swin_transf.layers[1].blocks[1]
    assert blk.res == blk.window and isinstance(blk.attn.qkv, pq.QuantLinear)
    x = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32)
    want = jswin.swin_block(qp["stages"][1]["blocks"][1], to_jax_swin(cfg, "xla"),
                            jnp.asarray(x), 1, 1, None, False, 0.0, JDT[dtype])
    with torch.no_grad():
        got = blk(torch.from_numpy(x), dtype)
    assert got.dtype == torch.float32  # the quantized products return fp32
    assert _rel_max(got, want) <= TOL[dtype]


def _jax_captions(qp, cfg, imgs, beam, max_len, n_out, step_impl="pallas"):
    jc = to_jax_model(cfg)
    cap = jc.captioner
    dcfg = DecodeConfig(beam_size=beam, how_many_outputs=n_out, max_seq_len=max_len,
                        sos_idx=cap.sos_idx, eos_idx=cap.eos_idx, chunk_schedule=(max_len,))

    @jax.jit
    def run(p, x):
        enc = je2e.forward_enc(p, jc, jnormalize(x))
        return jbs.beam_search(p["captioner"], cap, enc, dcfg, dtype=jc.compute_dtype)

    with jax_pallas_path():
        jdc.set_dyn_step_impl(step_impl)
        res = run(je2e.prepare_inference_params(jax.tree.map(jnp.asarray, qp), jc),
                  jnp.asarray(imgs))
    return jbs.captions_from_result(res)


# per (mode, seed), an EOS id these quantized random weights emit a few tokens in
@pytest.mark.parametrize("mode, seed, eos", [
    ("w8a8", 0, 163), ("w8a8", 1, 774), ("w8a8", 2, 569), ("w8", 2, 225)])
def test_quantized_captioner_tokens_equal_jax(mode, seed, eos):
    """api.Captioner on a model quantized end to end (every linear) against
    the JAX package's forward_enc + beam_search on the same quantized tree,
    "fused" backbone without a single-window stage (at the tiny widths the
    JAX gates would put one on the halves, where the port, like JAX at
    Swin-L, runs plain blocks), fp32: tokens and lengths equal. Log-probs
    within 1e-4 under w8a8 (the int8 values agree, only sums run in another
    order); 5e-3 under w8, where every activation is rounded to bf16 before
    its product and an fp32 difference of 1e-7 can tip one such rounding,
    a step of 2^-8 of that value."""
    cfg = dataclasses.replace(
        FUSED_E2E, swin=GRID_SWIN,
        captioner=dataclasses.replace(FUSED_E2E.captioner, eos_idx=eos))
    qp, model = _quantized_pair(cfg, mode, 30 + seed)
    imgs = np.random.default_rng(seed).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want_caps, want_lps = _jax_captions(qp, cfg, imgs, 3, 12, 2)
    got_caps, got_lps = Captioner(model, cfg, {
        "beam_size": 3, "how_many_outputs": 2, "beam_max_seq_len": 12}, device="cpu")(imgs)
    assert got_caps == want_caps
    assert any(eos in toks for row in got_caps for toks in row)
    tol = 1e-4 if mode == "w8a8" else 5e-3
    for g_img, w_img in zip(got_lps, want_lps):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_quantized_decoder_gives_way_from_fused_step(monkeypatch):
    """A decoder-only w8a8 model with step_impl="pallas_fused": both packages
    take the unfused step (K2, then LN2 and the cross-attention) because Wq is
    quantized; tokens equal the JAX package's under its "pallas_fused"."""
    from on_device_image_captioning_torch.decode import cache as pdc

    cfg = dataclasses.replace(
        FUSED_E2E, captioner=dataclasses.replace(FUSED_E2E.captioner, eos_idx=611))
    qp, model = _quantized_pair(cfg, "w8a8", 30, lambda p: bool(jq.DECODER_PAT.search(p)))
    assert isinstance(model.decoders[0].mha.Wq, pq.QuantLinear)
    assert not isinstance(model.encoders[0].ff.linear_1, pq.QuantLinear)

    def refuse(*a, **k):
        raise AssertionError("the fused step ran on a quantized Wq")

    monkeypatch.setattr(pdc, "_dyn_cross_fused_step", refuse)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want_caps, _ = _jax_captions(qp, cfg, imgs, 3, 10, 1, step_impl="pallas_fused")
    got_caps, _ = Captioner(model, cfg, {"beam_size": 3, "beam_max_seq_len": 10},
                            device="cpu", step_impl="pallas_fused")(imgs)
    assert got_caps == want_caps


def test_calibrate_and_static_outputs_equal_jax():
    """calibrate: the same x_scales as the JAX calibrate (the largest amax
    recorded per path, a path named twice among them), then the static w8a8
    caption encoder's output against the JAX one within 1e-4 of its max."""
    cap_cfg = TINY_CAP
    params = numpy_tree(jcap.captioner_init(jax.random.PRNGKey(4), to_jax_cap(cap_cfg)))
    qp = jq.quantize_tree(params, "w8a8_static")
    jpaths = ["input_linear", "encoders/0/stc_exp/key_embed", "encoders/1/ff/linear_2",
              "enc_reduce_group", "encoders/0/stc_exp/key_embed"]
    amaxes = [3.1, 0.7, 5.5, 2.25, 0.9]
    jcal = jq.calibrate(qp, list(zip(jpaths, amaxes)))
    model = ExpansionNetV2(cap_cfg)
    model.load_state_dict(captioner_state_dict(params))
    pq.quantize_model(model, "w8a8_static")
    pq.calibrate(model, [(re.sub("/", ".", p), a) for p, a in zip(jpaths, amaxes)])
    got = captioner_state_dict(jcal)
    for jp in set(jpaths):
        name = jp.replace("/", ".")
        layer = model.get_submodule(name)
        assert layer.mode == "a8" and layer.x_scale.dtype == torch.float32
        np.testing.assert_array_equal(layer.x_scale.numpy(), _jax_node(jcal, jp)["x_scale"])
        torch.testing.assert_close(got[name + ".x_scale"], layer.x_scale, rtol=0, atol=0)
    assert model.encoders[1].ff.linear_1.x_scale is None  # not calibrated: dynamic
    feats = np.random.default_rng(6).standard_normal((2, 7, cap_cfg.img_feature_dim)).astype(
        np.float32)
    want = jcap.forward_enc(jax.tree.map(jnp.asarray, jcal), to_jax_cap(cap_cfg), jnp.asarray(feats))
    with torch.no_grad():
        out = model.eval().forward_enc(torch.from_numpy(feats))
    assert _rel_max(out, want) <= 1e-4


def _jax_node(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def test_dequantize_model_equals_jax_dequantize_tree():
    """dequantize_model of a w8 model holds the JAX dequantize_tree's bf16
    weights (in fp32 storage), the patch-embed convolution back in its layout;
    w8a8 linears stay quantized in both."""
    cfg = TINY_E2E
    params = numpy_tree(je2e.init(jax.random.PRNGKey(8), to_jax_model(cfg)))
    qp = jq.quantize_tree(params, "w8")
    qp["captioner"]["vocab_linear"] = jq.quantize_linear(params["captioner"]["vocab_linear"], "w8a8")
    want = state_dict_from_jax(numpy_tree(jq.dequantize_tree(qp)), cfg)
    model = EndExpansionNetV2(cfg)
    pq.load_quantized_state_dict(model, state_dict_from_jax(qp, cfg))
    got = pq.dequantize_model(model).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert isinstance(model.swin_transf.patch_embed.proj, torch.nn.Conv2d)
    assert isinstance(model.vocab_linear, pq.QuantLinear)


def test_quantize_cli_help():
    with pytest.raises(SystemExit) as exit_info:
        qcli.main(["--help"])
    assert exit_info.value.code == 0


def test_quantize_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):  # before any loading
        qcli.main(["--load_path", "missing.pth", "--vocab_path", "missing.json",
                   "--output", "out.pth"])


@pytest.mark.parametrize("scheme, halves", [("w8a8", ["encoder", "decoder"]), ("w8", ["decoder"])])
def test_quantize_cli_functions_save_and_load_back(tmp_path, capsys, scheme, halves):
    """What `cli/quantize.py::main` does, at the tiny configuration (the full
    one is too large for a CPU test): load a reference checkpoint, quantize the
    halves, print the size line, save; the saved file loads back through
    load_reference_state_dict into a fresh model that equals the quantized one
    and captions alike."""
    cfg = FUSED_E2E
    params = numpy_tree(je2e.init(jax.random.PRNGKey(11), to_jax_model(cfg)))
    ckpt = tmp_path / "rf_model.pth"
    torch.save({"model_state_dict": state_dict_from_jax(params, cfg)}, ckpt)
    model = EndExpansionNetV2(cfg)
    load_reference_state_dict(model, torch.load(ckpt, weights_only=False))
    before, after = qcli.quantize_halves(model, scheme, halves)
    print(qcli.size_line(scheme, halves, before, after))
    assert re.fullmatch(
        rf"quantized \({scheme}, halves=\[.*\]\): \d+\.\d MB -> \d+\.\d MB\n",
        capsys.readouterr().out)
    assert after < before
    out = tmp_path / "q_model.pth"
    torch.save(model.state_dict(), out)
    fresh = EndExpansionNetV2(cfg)
    load_reference_state_dict(fresh, torch.load(out, weights_only=False))
    for k, v in model.state_dict().items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    assert (isinstance(fresh.encoders[0].ff.linear_1, pq.QuantLinear)) == ("encoder" in halves)
    imgs = np.random.default_rng(1).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    args = {"beam_size": 2, "beam_max_seq_len": 6}
    assert Captioner(model, cfg, args, device="cpu")(imgs)[0] == Captioner(
        fresh, cfg, args, device="cpu")(imgs)[0]
