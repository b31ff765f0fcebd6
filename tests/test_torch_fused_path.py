"""The window-resident ("fused") backbone path of the port against the JAX
package on the CPU: each kernel module, the backbone, and the slice through
`api.Captioner`; plus the port's own copies of the JAX-free host helpers.

Inputs come from numpy with a seed and go through the JAX function (its
Pallas kernels in interpret mode) and its counterpart in the port (on the CPU
the plain version of each kernel). Tolerances: fp32 atol = rtol = 2e-5, the
JAX package's own for these kernels (`tests/test_pallas_ops.py`): summation
order, and the TPU kernel's polynomial erf (|err| <= 3e-7) against the exact
erf here. bf16 atol = rtol = 2e-2: both sides round at the same places, so a
difference is an fp32 value that fell on the other side of a bf16 rounding
boundary (one ulp is 2^-8 relative).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.api import Captioner
from on_device_image_captioning_torch.data.text import Vocab
from on_device_image_captioning_torch.models.swin import SwinTransformer, shift_attn_mask
from on_device_image_captioning_torch.ops import stage_boundary as psb
from on_device_image_captioning_torch.ops import swin_block_fused as psbf
from on_device_image_captioning_torch.ops import window_layout as pwl
from on_device_image_captioning_torch.params.convert import swin_state_dict
from on_device_image_captioning_torch.utils import image as pimage
from on_device_image_captioning_tpu import api as japi
from on_device_image_captioning_tpu.data import text as jtext
from on_device_image_captioning_tpu.models import swin as jswin
from on_device_image_captioning_tpu.ops import stage_boundary as jsb
from on_device_image_captioning_tpu.ops import swin_block_fused as jsbf
from on_device_image_captioning_tpu.utils import image as jimage

from test_torch_harness import TINY_E2E, e2e_pair, jax_pallas_path, numpy_tree, to_jax_model, to_jax_swin

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]
WINDOW, SHIFT, RES, C, HEADS = 4, 2, 8, 32, 2  # a 2 x 2 grid of 16-token windows
N, NW, EPS = WINDOW * WINDOW, (RES // WINDOW) ** 2, 1e-5


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _norm(rng, width):
    scale = (1.0 + 0.2 * rng.standard_normal(width)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(width)).astype(np.float32)
    return ({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            (torch.from_numpy(scale), torch.from_numpy(bias)))


def _linear(rng, k, n, dtype, bias=True):
    """(JAX node {"w" (in, out), "b"}, port operand (w in `dtype`, b fp32)).
    The JAX kernels cast the fp32 weight to the compute dtype per call; the
    port receives it already cast."""
    w = (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)
    node = {"w": jnp.asarray(w)}
    b_t = None
    if bias:
        b = (0.2 * rng.standard_normal(n)).astype(np.float32)
        node["b"] = jnp.asarray(b)
        b_t = torch.from_numpy(b)
    return node, (torch.from_numpy(w).to(getattr(torch, dtype)), b_t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_patch_embed_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    jx, px = _pair(rng.standard_normal((2, RES, RES, 48)).astype(np.float32), dtype)
    jproj, pproj = _linear(rng, 48, C, dtype)
    jnorm, pnorm = _norm(rng, C)
    want = jsb.patch_embed_fused(jx, jproj, jnorm, WINDOW, EPS)
    got = psb.patch_embed_fused(px, pproj, pnorm, WINDOW, EPS)
    assert got.shape == want.shape == (2 * NW, N, C) and str(got.dtype) == "torch." + dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_downsample_matches_jax_kernel(dtype):
    rng = np.random.default_rng(1)
    w_in = 4  # 16 x 16 tokens in, a 2 x 2 grid of windows out
    jx, px = _pair(rng.standard_normal((2 * w_in * w_in, N, C)).astype(np.float32), dtype)
    jnorm, pnorm = _norm(rng, 4 * C)
    jred, (pred, _) = _linear(rng, 4 * C, 2 * C, dtype, bias=False)
    want = jsb.downsample_fused(jx, jnorm, jred, w_in, WINDOW, EPS)
    got = psb.downsample_fused(px, pnorm, pred, w_in, WINDOW, EPS)
    assert got.shape == want.shape == (2 * 4, N, 2 * C)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "shifts, masked",
    [(None, False), ((0, SHIFT), True), ((SHIFT, 0), False), (None, True)],
    ids=["plain", "to_shifted", "from_shifted", "masked_no_transition"],
)
def test_attn_half_matches_jax_kernel(dtype, shifts, masked):
    """No transition, and both directions of it: the JAX kernel folds the
    transition in as `transition_pieces`' one-hot products, the port as index
    arithmetic; the mask belongs to the layout the block runs in."""
    rng = np.random.default_rng(2)
    jx, px = _pair(rng.standard_normal((2 * NW, N, C)).astype(np.float32), dtype)
    jnorm, pnorm = _norm(rng, C)
    jqkv, pqkv = _linear(rng, C, 3 * C, dtype)
    jproj, pproj = _linear(rng, C, C, dtype)
    bias = (0.5 * rng.standard_normal((HEADS, N, N))).astype(np.float32)
    mask = shift_attn_mask(RES, WINDOW, SHIFT) if masked else None
    scale = (C // HEADS) ** -0.5
    kw = {}
    if shifts is not None:
        dr, dc, p4 = jswin.transition_pieces(RES, WINDOW, *shifts)
        kw = dict(transition=(dr, dc, RES // WINDOW), p4=jnp.asarray(p4))
    want = jsbf.swin_attn_half_fused(
        jx, {"norm1": jnorm, "attn": {"qkv": jqkv, "proj": jproj}}, jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), HEADS, NW, scale, EPS, **kw)
    got = psbf.swin_attn_half(
        px, pnorm, pqkv, pproj, torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), HEADS, scale, EPS,
        None if shifts is None else (RES, *shifts))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_half_matches_jax_kernel(dtype):
    rng = np.random.default_rng(3)
    jx, px = _pair(2.0 * rng.standard_normal((2 * NW, N, C)).astype(np.float32), dtype)
    jnorm, pnorm = _norm(rng, C)
    jfc1, pfc1 = _linear(rng, C, 4 * C, dtype)
    jfc2, pfc2 = _linear(rng, 4 * C, C, dtype)
    want = jsbf.swin_mlp_half_fused(jx, {"norm2": jnorm, "mlp": {"fc1": jfc1, "fc2": jfc2}}, EPS)
    got = psbf.swin_mlp_half(px, pnorm, pfc1, pfc2, EPS)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("res, window", [(8, 4), (16, 4), (24, 12)])
def test_window_transition_matches_jax_kernel(dtype, res, window):
    """A permutation of rows: equal to the JAX transition kernel exactly, both
    directions, and the two directions undo each other."""
    rng = np.random.default_rng(res)
    jx, px = _pair(
        rng.standard_normal((2 * (res // window) ** 2, window * window, 8)).astype(np.float32),
        dtype)
    shift = window // 2
    for f, t in ((0, shift), (shift, 0)):
        want = jswin._apply_transition_kernel(jx, res, window, f, t)
        got = psbf.window_transition(px, res, window, f, t)
        np.testing.assert_array_equal(_np(got), _np(want))
        back = psbf.window_transition(got, res, window, t, f)
        np.testing.assert_array_equal(_np(back), _np(px))


@pytest.mark.parametrize("res, window", [(96, 12), (48, 12), (24, 12), (16, 4), (8, 4)])
def test_source_rows_match_the_layout_tables(res, window):
    """The index arithmetic of `csrc/window_layout.cuh` (mirrored by
    `source_rows`) against what it replaces: the transition permutation, the
    window partition, and the 2x2 merge in the reference's concat order."""
    shift = window // 2
    for f, t in ((0, shift), (shift, 0)):
        np.testing.assert_array_equal(
            pwl.source_rows("transition", res, window, delta=(t - f) % res),
            pwl.window_transition_perm(res, window, f, t))
        np.testing.assert_array_equal(
            pwl.window_transition_perm(res, window, f, t),
            jswin.window_transition_perm(res, window, f, t))
    raster = torch.arange(res * res).reshape(1, res, res, 1)
    np.testing.assert_array_equal(
        pwl.source_rows("raster", res, window),
        pwl.window_partition(raster, window).reshape(-1).numpy())
    if (res // 2) % window == 0:
        rows = pwl.window_reverse(torch.arange(res * res).reshape(-1, window * window, 1),
                                  window, res, res)  # (1, res, res, 1): row of each pixel
        merged = [rows[:, 0::2, 0::2], rows[:, 1::2, 0::2], rows[:, 0::2, 1::2], rows[:, 1::2, 1::2]]
        for seg, want in enumerate(merged):
            np.testing.assert_array_equal(
                pwl.source_rows("merge", res, window, seg=seg),
                pwl.window_partition(want, window).reshape(-1).numpy())


# the backbone of tests/test_pallas_ops.py:90-93: a two-block stage (the short
# loop) and a four-block stage (JAX: first pair alone, then the scanned pair)
BACKBONE = pcfg.SwinConfig(
    img_size=64, patch_size=4, embed_dim=16, depths=(2, 4), num_heads=(2, 4), window_size=4,
    attention_impl="fused",
)


def _backbone_pair(cfg, seed):
    jc = to_jax_swin(cfg)
    params = jswin.swin_init(jax.random.PRNGKey(seed), jc)
    model = SwinTransformer(cfg)
    e2e_cfg = dataclasses.replace(
        TINY_E2E, swin=cfg,
        captioner=dataclasses.replace(TINY_E2E.captioner, img_feature_dim=cfg.num_features))
    sd = swin_state_dict(numpy_tree(params), e2e_cfg)
    model.load_state_dict({k[len("swin_transf."):]: v for k, v in sd.items()}, strict=True)
    return jc, params, model.eval()


@pytest.mark.parametrize("halves", [False, True], ids=["jax_picks_mode", "halves_override"])
def test_fused_backbone_matches_jax_fused(halves):
    """`swin_apply` with attention_impl="fused" (as JAX picks the stage modes,
    and with every stage forced onto the half-block kernels the port ports)
    against the port's window-resident path and its own "pallas" path."""
    jc, params, model = _backbone_pair(BACKBONE, 7)
    imgs = np.random.default_rng(17).standard_normal((2, 64, 64, 3)).astype(np.float32)
    try:
        if halves:
            jswin.set_stage_mode_override({0: "halves", 1: "halves"})
        with jax_pallas_path():
            want = jax.jit(lambda p, x: jswin.swin_apply(p, jc, x))(
                jswin.prepare_inference_params(params, jc), jnp.asarray(imgs))
    finally:
        jswin.set_stage_mode_override(None)
    plain = SwinTransformer(dataclasses.replace(BACKBONE, attention_impl="pallas")).eval()
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
        model.prepare_inference()
        got_prepared = model(torch.from_numpy(imgs))
        got_plain = plain(torch.from_numpy(imgs))
    assert got.shape == want.shape == (2, 64, BACKBONE.num_features)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(got_prepared), _np(got), rtol=0, atol=0)
    np.testing.assert_allclose(_np(got), _np(got_plain), **TOL["float32"])


def test_fused_backbone_bf16_close_to_jax():
    jc, params, model = _backbone_pair(BACKBONE, 8)
    imgs = np.random.default_rng(18).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with jax_pallas_path():
        want = jax.jit(lambda p, x: jswin.swin_apply(p, jc, x, dtype=jnp.bfloat16))(
            params, jnp.asarray(imgs))
    model.prepare_inference(torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # through six blocks one-ulp differences compound: the existing bf16
    # backbone tolerance of tests/test_torch_models.py
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-2, atol=5e-2)


def test_fused_path_refuses_what_the_jax_plan_refuses():
    with pytest.raises(ValueError, match="ape"):
        SwinTransformer(dataclasses.replace(BACKBONE, ape=True))
    with pytest.raises(ValueError, match="tile"):  # 12 x 12 tokens, windows of 4: 3 x 3
        SwinTransformer(dataclasses.replace(BACKBONE, img_size=48))


@pytest.mark.parametrize("seed, eos", [(0, 553), (1, 75)])
def test_captioner_fused_tokens_equal_jax_captioner(seed, eos):
    """The slice as a whole: `api.Captioner` on the "fused" path gives the JAX
    `api.Captioner`'s fp32 captions token for token, same weights and images."""
    cfg = dataclasses.replace(
        TINY_E2E, swin=dataclasses.replace(TINY_E2E.swin, attention_impl="fused"),
        captioner=dataclasses.replace(TINY_E2E.captioner, eos_idx=eos))
    params, model = e2e_pair(cfg, 10 + seed)
    imgs = np.random.default_rng(seed).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    args = {"beam_size": 3, "how_many_outputs": 2, "beam_max_seq_len": 12}
    normalized = np.asarray(jimage.normalize_on_device(jnp.asarray(imgs)))
    with jax_pallas_path():
        want_caps, want_lps = japi.Captioner(params, to_jax_model(cfg), args).beam_search(normalized)
    got_caps, got_lps = Captioner(model, cfg, args, device="cpu")(imgs)
    assert got_caps == want_caps
    assert any(eos in toks for row in got_caps for toks in row)
    for g_img, w_img in zip(got_lps, want_lps):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)  # fp32 stack


def test_captioner_without_a_card_raises_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model = e2e_pair(TINY_E2E, 30)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Captioner(model, TINY_E2E)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Captioner(model, TINY_E2E, device="cuda:0")
    assert Captioner(model, TINY_E2E, device="cpu").device.type == "cpu"


def test_own_vocab_equals_the_jax_package(tmp_path):
    words = ["PAD", "SOS", "EOS", "UNK", "a", "dog", "runs", "on", "grass"]
    path = tmp_path / "vocab.json"
    path.write_text(json.dumps({w: i for i, w in enumerate(sorted(words))}))
    port, ref = Vocab.from_json(str(path)), jtext.Vocab.from_json(str(path))
    assert len(port) == len(ref) == len(words)
    assert port.word2idx == ref.word2idx and port.idx2word == ref.idx2word
    for name in ("pad_idx", "sos_idx", "eos_idx", "unk_idx"):
        assert getattr(port, name) == getattr(ref, name)
    w = port.word2idx
    for toks in ([w["SOS"], w["a"], w["dog"], w["runs"], w["EOS"], w["grass"]],
                 [w["a"], w["UNK"]], [w["SOS"], w["EOS"]], []):
        assert port.description(toks) == ref.description(toks)
    assert port.description([w["SOS"], w["a"], w["dog"], w["EOS"]]) == "A dog."


def test_own_image_helpers_equal_the_jax_package(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    paths = []
    for i, (mode, size) in enumerate([("RGB", (50, 40)), ("L", (31, 64)), ("RGB", (32, 32))]):
        shape = size[::-1] + ((3,) if mode == "RGB" else ())
        path = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
        paths.append(str(path))
    np.testing.assert_array_equal(pimage.IMAGENET_MEAN, jimage.IMAGENET_MEAN)
    np.testing.assert_array_equal(pimage.IMAGENET_STD, jimage.IMAGENET_STD)
    for p in paths:
        np.testing.assert_array_equal(pimage.load_image_rgb(p, 32), jimage.load_image_rgb(p, 32))
    got, want = pimage.preprocess_batch(paths, 32), jimage.preprocess_batch(paths, 32)
    assert got.shape == (3, 32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pimage.preprocess_batch(paths[:1], 32), want[:1])
