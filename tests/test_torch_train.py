"""The port's training path against the JAX package on the CPU: the five
training functions of the Swin block (forwards with per-image stochastic-depth
scales, backwards that recompute from the saved x and x2), the gradients of
the window transition and of LayerNorm, the `train=True` backbone, the whole
cross-entropy step, RAdam, the schedules, the loss and dropout.

Inputs come from numpy with a seed and go through the JAX function (its Pallas
kernels in interpret mode, as `tests/test_swin_train_fused.py` runs them) and
its counterpart in the port (on the CPU the plain version of each kernel: the
written-out forward and backward formulas). Random streams differ between the
frameworks, so where stochastic depth enters, the test walks the JAX key chain,
draws the Bernoulli scales there and hands them to the port through
`drop_path_scales`.

Tolerances. Every gradient is held relative to the largest magnitude of its
tensor (sums over all rows: an element near zero is as exact as the terms it
sums): fp32 2e-5 (summation order, and the TPU kernels' polynomial erf,
|err| <= 3e-7, against the exact erf here), bf16 2e-2 (both sides round at the
same places; a difference is an fp32 value that fell on the other side of a
bf16 rounding boundary, 2^-8 relative). Through the stacked backbone and the
XE step (fp32): 1e-4 relative to the tensor's max, the error of up to six
blocks and five caption layers compounded. The written-out backwards against
`torch.autograd` of the plain forwards: 2e-6 relative to max.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.models import common as pcommon
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
from on_device_image_captioning_torch.models.swin import SwinTransformer, shift_attn_mask
from on_device_image_captioning_torch.ops import layernorm as pln
from on_device_image_captioning_torch.ops import swin_block_fused as psbf
from on_device_image_captioning_torch.params.convert import state_dict_from_jax, swin_state_dict
from on_device_image_captioning_torch.train import losses as plosses
from on_device_image_captioning_torch.train import radam as pradam
from on_device_image_captioning_torch.train import schedules as psched
from on_device_image_captioning_torch.train import train_step as pstep
from on_device_image_captioning_tpu.models import common as jcommon
from on_device_image_captioning_tpu.models import end_to_end as je2e
from on_device_image_captioning_tpu.models import swin as jswin
from on_device_image_captioning_tpu.ops import layernorm as jln
from on_device_image_captioning_tpu.ops import swin_block_fused as jsbf
from on_device_image_captioning_tpu.params.torch_convert import convert_end_to_end, convert_swin
from on_device_image_captioning_tpu.train import losses as jlosses
from on_device_image_captioning_tpu.train import radam as jradam
from on_device_image_captioning_tpu.train import schedules as jsched
from on_device_image_captioning_tpu.train import train_step as jstep

from test_torch_harness import TINY_CAP, TINY_SWIN, numpy_tree, to_jax_model, to_jax_swin

GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
STACK_TOL = 1e-4
DTYPES = ["float32", "bfloat16"]
WINDOW, SHIFT, RES, C, HEADS, HIDDEN = 4, 2, 8, 32, 2, 128
N, NW, B, EPS = WINDOW * WINDOW, (RES // WINDOW) ** 2, 3, 1e-5
SCALE = (C // HEADS) ** -0.5
# per-image scales in {1, 0, 1 / keep}, mixed over the three images
M1 = np.array([1.0, 0.0, 1.0 / 0.9], np.float32)
M2 = np.array([1.0 / 0.8, 1.0, 0.0], np.float32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x, jnp.float32))


def assert_close_to_max(got, want, tol, what="", floor=0.0):
    """|got - want| <= tol * max|want| + floor elementwise."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30) + floor
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs error {err:.3e} over {bound:.3e}"


def assert_all_close_to_max(got, want, names, tol):
    """Each tensor of a model's gradients relative to its own max, plus a
    floor of a tenth of that relative to the largest gradient of the model:
    some gradients are zero in exact arithmetic (the bias of k under the
    softmax, a LayerNorm bias under the next LayerNorm), and what is left of
    them is the rounding of terms as large as the other gradients."""
    floor = 0.1 * tol * max(float(np.abs(_np(w)).max()) for w in want)
    for g, w, name in zip(got, want, names):
        assert_close_to_max(g, w, tol, name, floor)


def _block_params(rng, qkv_bias=True):
    """One block's parameters: the JAX tree (fp32) and the port's operands
    (fp32 master tensors that require a gradient)."""
    def lin(k, n, bias=True):
        node = {"w": (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)}
        if bias:
            node["b"] = (0.2 * rng.standard_normal(n)).astype(np.float32)
        return node

    def norm(c):
        return {"scale": (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                "bias": (0.2 * rng.standard_normal(c)).astype(np.float32)}

    tree = {"norm1": norm(C), "attn": {"qkv": lin(C, 3 * C, qkv_bias), "proj": lin(C, C)},
            "norm2": norm(C), "mlp": {"fc1": lin(C, HIDDEN), "fc2": lin(HIDDEN, C)}}

    def t(a):
        return torch.from_numpy(a.copy()).requires_grad_()

    def port_lin(node):
        return (t(node["w"]), t(node["b"]) if "b" in node else None)

    def port_norm(node):
        return (t(node["scale"]), t(node["bias"]))

    port = {"norm1": port_norm(tree["norm1"]), "qkv": port_lin(tree["attn"]["qkv"]),
            "proj": port_lin(tree["attn"]["proj"]), "norm2": port_norm(tree["norm2"]),
            "fc1": port_lin(tree["mlp"]["fc1"]), "fc2": port_lin(tree["mlp"]["fc2"])}
    return jax.tree.map(jnp.asarray, tree), port


def _block_inputs(seed, dtype, masked):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * NW, N, C)).astype(np.float32)
    dy = rng.standard_normal((B * NW, N, C)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((HEADS, N, N))).astype(np.float32)
    mask = shift_attn_mask(RES, WINDOW, SHIFT) if masked else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = (jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt), jnp.asarray(bias),
          None if mask is None else jnp.asarray(mask))
    px = (torch.from_numpy(x).to(tdt).requires_grad_(), torch.from_numpy(dy).to(tdt),
          torch.from_numpy(bias).requires_grad_(),
          None if mask is None else torch.from_numpy(mask))
    return rng, jx, px


def _compute_operands(port, dtype):
    """The block's operands as a kernel wrapper takes them: LayerNorm
    parameters and biases fp32, (in, out) weights in the compute dtype."""
    def lin(pair):
        w, b = pair
        return (w.detach().to(dtype), None if b is None else b.detach())

    def norm(pair):
        return (pair[0].detach(), pair[1].detach())

    return (norm(port["norm1"]), lin(port["qkv"]), lin(port["proj"]), norm(port["norm2"]),
            lin(port["fc1"]), lin(port["fc2"]))


def _port_grads(y, dy, leaves):
    return torch.autograd.grad(y, [t for t in leaves if t is not None], dy)


def _compare_linear(got_w, got_b, node, tol, what):
    assert_close_to_max(got_w, node["w"], tol, what + ".w")
    if got_b is not None:
        assert_close_to_max(got_b, node["b"], tol, what + ".b")
    else:
        assert "b" not in node


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_block_train_matches_jax(dtype, masked):
    """B9a forward (y and the saved x2) and, through the autograd function,
    B9c + B9b: every gradient of `swin_block_fused_train` under a random
    cotangent, dbias and a qkv without bias among them."""
    rng, (jx, jdy, jbias, jmask), (px, pdy, pbias, pmask) = _block_inputs(10, dtype, masked)
    tree, port = _block_params(rng, qkv_bias=False)
    jm1, jm2 = jnp.asarray(M1), jnp.asarray(M2)
    want_y, want_x2 = jsbf._train_fwd_call(
        jx, tree, jbias, jmask, jm1, jm2, HEADS, NW, SCALE, EPS)
    _, vjp = jax.vjp(
        lambda x_, p_, b_: jsbf.swin_block_fused_train(
            x_, p_, b_, jmask, jm1, jm2, HEADS, NW, SCALE, EPS), jx, tree, jbias)
    want_dx, want_dp, want_dbias = vjp(jdy)

    tol = GRAD_TOL[dtype]
    m1, m2 = torch.from_numpy(M1), torch.from_numpy(M2)
    args = (port["norm1"], port["qkv"], port["proj"], port["norm2"], port["fc1"], port["fc2"])
    got_y, got_x2 = psbf.swin_block_train_forward(
        px.detach(), *_compute_operands(port, px.dtype), pbias.detach(), pmask, m1, m2, HEADS,
        SCALE, EPS)
    assert_close_to_max(got_y, want_y, tol, "y")
    assert_close_to_max(got_x2, want_x2, tol, "x2")

    y = psbf.swin_block_train(px, *args, pbias, pmask, m1, m2, HEADS, SCALE, EPS)
    assert y.dtype == px.dtype
    assert_close_to_max(y, want_y, tol, "y (autograd function)")
    leaves = [px, *port["norm1"], *port["qkv"], *port["proj"], *port["norm2"], *port["fc1"],
              *port["fc2"], pbias]
    g = list(_port_grads(y, pdy, leaves))
    dx, dg1, dbe1, dwqkv, dwproj, dbproj, dg2, dbe2, dw1, db1, dw2, db2, dbias = g
    assert dx.dtype == px.dtype and dwqkv.dtype == torch.float32  # master-weight gradients
    assert_close_to_max(dx, want_dx, tol, "dx")
    assert_close_to_max(dg1, want_dp["norm1"]["scale"], tol, "dg1")
    assert_close_to_max(dbe1, want_dp["norm1"]["bias"], tol, "dbe1")
    _compare_linear(dwqkv, None, want_dp["attn"]["qkv"], tol, "qkv")
    _compare_linear(dwproj, dbproj, want_dp["attn"]["proj"], tol, "proj")
    assert_close_to_max(dg2, want_dp["norm2"]["scale"], tol, "dg2")
    assert_close_to_max(dbe2, want_dp["norm2"]["bias"], tol, "dbe2")
    _compare_linear(dw1, db1, want_dp["mlp"]["fc1"], tol, "fc1")
    _compare_linear(dw2, db2, want_dp["mlp"]["fc2"], tol, "fc2")
    assert_close_to_max(dbias, want_dbias, tol, "dbias")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_attn_half_train_matches_jax(dtype, masked):
    """B10a forward and its backward B9b against `swin_attn_half_fused_train`."""
    rng, (jx, jdy, jbias, jmask), (px, pdy, pbias, pmask) = _block_inputs(20, dtype, masked)
    tree, port = _block_params(rng)
    p_attn = {"norm1": tree["norm1"], "attn": tree["attn"]}
    jm1 = jnp.asarray(M1)
    want_y, vjp = jax.vjp(
        lambda x_, p_, b_: jsbf.swin_attn_half_fused_train(
            x_, p_, b_, jmask, jm1, HEADS, NW, SCALE, EPS), jx, p_attn, jbias)
    want_dx, want_dp, want_dbias = vjp(jdy)

    tol = GRAD_TOL[dtype]
    y = psbf.swin_attn_half_train(px, port["norm1"], port["qkv"], port["proj"], pbias, pmask,
                                  torch.from_numpy(M1), HEADS, SCALE, EPS)
    assert_close_to_max(y, want_y, tol, "y")
    leaves = [px, *port["norm1"], *port["qkv"], *port["proj"], pbias]
    dx, dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias = _port_grads(y, pdy, leaves)
    assert_close_to_max(dx, want_dx, tol, "dx")
    assert_close_to_max(dg1, want_dp["norm1"]["scale"], tol, "dg1")
    assert_close_to_max(dbe1, want_dp["norm1"]["bias"], tol, "dbe1")
    _compare_linear(dwqkv, dbqkv, want_dp["attn"]["qkv"], tol, "qkv")
    _compare_linear(dwproj, dbproj, want_dp["attn"]["proj"], tol, "proj")
    assert_close_to_max(dbias, want_dbias, tol, "dbias")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_half_train_matches_jax(dtype):
    """B10b forward and its backward B9c against `swin_mlp_half_fused_train`."""
    rng, (jx, jdy, _, _), (px, pdy, _, _) = _block_inputs(30, dtype, False)
    tree, port = _block_params(rng)
    p_mlp = {"norm2": tree["norm2"], "mlp": tree["mlp"]}
    want_y, vjp = jax.vjp(
        lambda x_, p_: jsbf.swin_mlp_half_fused_train(
            x_, p_, jnp.asarray(M2), EPS, NW * N), jx.reshape(-1, C), p_mlp)
    want_dx, want_dp = vjp(jdy.reshape(-1, C))

    tol = GRAD_TOL[dtype]
    y = psbf.swin_mlp_half_train(px, port["norm2"], port["fc1"], port["fc2"],
                                 torch.from_numpy(M2), EPS)
    assert_close_to_max(y.reshape(-1, C), want_y, tol, "y")
    leaves = [px, *port["norm2"], *port["fc1"], *port["fc2"]]
    dx, dg2, dbe2, dw1, db1, dw2, db2 = _port_grads(y, pdy, leaves)
    assert_close_to_max(dx.reshape(-1, C), want_dx, tol, "dx2")
    assert_close_to_max(dg2, want_dp["norm2"]["scale"], tol, "dg2")
    assert_close_to_max(dbe2, want_dp["norm2"]["bias"], tol, "dbe2")
    _compare_linear(dw1, db1, want_dp["mlp"]["fc1"], tol, "fc1")
    _compare_linear(dw2, db2, want_dp["mlp"]["fc2"], tol, "fc2")


@pytest.mark.parametrize("masked", [False, True])
def test_written_out_backwards_match_autograd_of_plain_forwards(masked):
    """The step-by-step plain backwards (what the card holds B9b and B9c
    against) equal `torch.autograd` of the plain forwards at fp32."""
    rng, _, (px, pdy, pbias, pmask) = _block_inputs(40, "float32", masked)
    _, port = _block_params(rng, qkv_bias=masked)
    m1, m2 = torch.from_numpy(M1), torch.from_numpy(M2)
    tol = 2e-6

    x2 = psbf.swin_attn_half_train_reference(
        px, port["norm1"], port["qkv"], port["proj"], pbias, pmask, m1, HEADS, SCALE, EPS)
    leaves = [px, *port["norm1"], *port["qkv"], *port["proj"], pbias]
    want = _port_grads(x2, pdy, leaves)
    detached = [tuple(None if t is None else t.detach() for t in port[k])
                for k in ("norm1", "qkv", "proj")]
    dx, dg1, dbe1, dwqkv, dbqkv, dwproj, dbproj, dbias = psbf.swin_attn_bwd_reference(
        px.detach(), pdy, *detached, pbias.detach(), pmask, m1, HEADS, SCALE, EPS)
    got = [dx, dg1, dbe1, dwqkv] + ([dbqkv] if masked else []) + [dwproj, dbproj, dbias]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_to_max(g, w, tol, f"attention half, gradient {i}")

    y = psbf.swin_mlp_half_train_reference(
        px, port["norm2"], port["fc1"], port["fc2"], m2, EPS)
    leaves = [px, *port["norm2"], *port["fc1"], *port["fc2"]]
    want = _port_grads(y, pdy, leaves)
    detached = [tuple(t.detach() for t in port[k]) for k in ("norm2", "fc1", "fc2")]
    got = psbf.swin_mlp_bwd_reference(px.detach(), pdy, *detached, m2, EPS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_to_max(g, w, tol, f"MLP half, gradient {i}")


@pytest.mark.parametrize("shifts", [(0, SHIFT), (SHIFT, 0)])
def test_window_transition_backward_is_the_inverse_transition(shifts):
    f, t = shifts
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.standard_normal((2 * NW, N, 8)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2 * NW, N, 8)).astype(np.float32))
    y = psbf.window_transition_train(x, RES, WINDOW, f, t)
    torch.testing.assert_close(y, psbf.window_transition_reference(x, RES, WINDOW, f, t),
                               rtol=0, atol=0)
    (dx,) = torch.autograd.grad(y, x, g)
    torch.testing.assert_close(dx, psbf.window_transition_reference(g, RES, WINDOW, t, f),
                               rtol=0, atol=0)
    # and equals autograd of the plain gather, and the JAX gather-only VJP
    (want,) = torch.autograd.grad(psbf.window_transition_reference(x, RES, WINDOW, f, t), x, g)
    torch.testing.assert_close(dx, want, rtol=0, atol=0)
    _, vjp = jax.vjp(lambda a: jswin._window_transition_diff(a, 2, RES, WINDOW, f, t),
                     jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(vjp(jnp.asarray(g.numpy()))[0]))
    assert psbf.window_transition_train(x, RES, WINDOW, f, f) is x


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_backward_matches_jax(dtype):
    rng = np.random.default_rng(60)
    x = (2.0 * rng.standard_normal((6, 10, 48)) + 0.5).astype(np.float32)
    g = rng.standard_normal((6, 10, 48)).astype(np.float32)
    w = (1.0 + 0.3 * rng.standard_normal(48)).astype(np.float32)
    b = (0.3 * rng.standard_normal(48)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, vjp = jax.vjp(lambda x_, w_, b_: jln.layernorm_pallas(x_, w_, b_, EPS),
                          jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(g).astype(jdt))
    px = torch.from_numpy(x).to(tdt).requires_grad_()
    pw, pb = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = pln.layernorm_autograd(px, pw, pb, EPS)
    got = torch.autograd.grad(y, [px, pw, pb], torch.from_numpy(g).to(tdt))
    tol = GRAD_TOL[dtype]
    assert_close_to_max(y, want_y, tol, "y")
    for name, a, c in zip(("dx", "dscale", "dbias"), got, want):
        assert_close_to_max(a, c, tol, name)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32


def test_per_image_scales_of_the_wrong_shape_raise():
    rng, _, (px, _, pbias, _) = _block_inputs(70, "float32", False)
    _, port = _block_params(rng)
    ok = torch.from_numpy(M1)
    args = (port["norm1"], port["qkv"], port["proj"], port["norm2"], port["fc1"], port["fc2"])
    for bad in (torch.ones(B * NW + 1), torch.ones(B, 1), torch.ones(5), torch.ones(())):
        with pytest.raises(ValueError, match="per image"):
            psbf.swin_block_train(px, *args, pbias, None, bad, ok, HEADS, SCALE, EPS)
        with pytest.raises(ValueError, match="per image"):
            psbf.swin_attn_half_train(px, *args[:3], pbias, None, bad, HEADS, SCALE, EPS)
        with pytest.raises(ValueError, match="per image"):
            psbf.swin_mlp_half_train(px, *args[3:], bad, EPS)
        with pytest.raises(ValueError, match="per image"):
            psbf.swin_mlp_bwd(px.detach(), px.detach(), *args[3:], bad, EPS)
    with pytest.raises(ValueError, match="fp32"):
        psbf.swin_mlp_half_train(px, *args[3:], ok.double(), EPS)
    # one scale per window is no image of the mask's NW windows
    mask = torch.from_numpy(shift_attn_mask(RES, WINDOW, SHIFT))
    with pytest.raises(ValueError, match="whole images"):
        psbf.swin_attn_half_train(px, *args[:3], pbias, mask, torch.ones(B * NW), HEADS, SCALE,
                                  EPS)


# ---------------------------------------------------------------------------
# the backbone and the XE step: the JAX key chain gives the scales
# ---------------------------------------------------------------------------


def jax_drop_path_scales(cfg, rng, batch):
    """The per-block (m1, m2) that `swin_apply(train=True, rng=rng)` draws:
    one key for the embedding dropout, then per stage a key per block (a
    stage of depth >= 4 draws one key more, then the even blocks' keys, then
    the odd blocks', as its scan does); in a block the third and sixth keys of
    its stream are the two drop-path keys."""
    rngs = jcommon.RngStream(rng)
    rngs.next()
    total = sum(cfg.depths)
    rates = [cfg.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
    out, first = [], 0
    for depth in cfg.depths:
        if depth < 4:
            keys = [rngs.next() for _ in range(depth)]
        else:
            rngs.next()
            even = [rngs.next() for _ in range(depth // 2)]
            odd = [rngs.next() for _ in range(depth // 2)]
            keys = [k for pair in zip(even, odd) for k in pair]
        for key, rate in zip(keys, rates[first:first + depth]):
            stream = jcommon.RngStream(key)
            ks = [stream.next() for _ in range(6)]
            keep = 1.0 - rate
            pair = tuple(
                torch.from_numpy(np.array(jnp.where(
                    jax.random.bernoulli(k, keep, (batch,)), 1.0 / keep, 0.0), np.float32))
                for k in (ks[2], ks[5]))
            out.append(pair)
        first += depth
    return out


def _tree_grads(model, convert, *convert_args):
    """The model's .grad tensors, through the JAX package's checkpoint reader,
    in the JAX tree's shape (the reader only transposes and reshapes)."""
    sd = {name: p.grad for name, p in model.named_parameters()}
    assert all(g is not None for g in sd.values()), [n for n, g in sd.items() if g is None]
    return convert(sd, *convert_args)


def _compare_trees(got, want, tol):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree.leaves(got)
    assert len(flat_want) == len(flat_got)
    assert_all_close_to_max(flat_got, [w for _, w in flat_want],
                            [jax.tree_util.keystr(path) for path, _ in flat_want], tol)


@pytest.mark.parametrize("depths, stage_modes", [
    ((2, 2), None),            # whole-block training kernel at stage 0, plain stage 1
    ((2, 2), {0: "halves"}),   # the two training halves
    ((4, 2), None),            # a stage of depth 4: the JAX side draws its keys in scan order
])
def test_backbone_train_matches_jax(depths, stage_modes, monkeypatch):
    cfg = dataclasses.replace(TINY_SWIN, depths=depths, attention_impl="fused",
                              drop_path_rate=0.1)
    jcfg = to_jax_swin(cfg)
    if stage_modes:  # tiny widths always fit the whole-block kernel there: force the halves
        monkeypatch.setattr(jsbf, "eligible", lambda *a, **k: False)
    params = jswin.swin_init(jax.random.PRNGKey(0), jcfg)
    images = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def loss(p):
        y = jswin.swin_apply(p, jcfg, jnp.asarray(images), train=True, rng=key)
        return jnp.mean(y * y), y

    (want_loss, want_y), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    model = SwinTransformer(cfg, stage_modes)
    model_cfg = pcfg.ModelConfig(
        swin=cfg, captioner=dataclasses.replace(TINY_CAP, img_feature_dim=cfg.num_features))
    sd = swin_state_dict(numpy_tree(params), model_cfg, prefix="")
    model.load_state_dict(sd, strict=True)
    scales = jax_drop_path_scales(jcfg, key, 2)
    assert any(float(m.min()) == 0.0 or float(m.max()) > 1.0 for pair in scales for m in pair)
    y = model(torch.from_numpy(images), train=True, drop_path_scales=scales)
    assert_close_to_max(y, want_y, STACK_TOL, "tokens")
    (y * y).mean().backward()
    np.testing.assert_allclose(float((y * y).mean().detach()), float(want_loss), rtol=STACK_TOL)
    _compare_trees(_tree_grads(model, convert_swin, jcfg, ""), want_grads, STACK_TOL)


def test_backbone_train_plain_paths_match_the_kernel_path():
    """attention_impl="pallas" trains on the plain backbone; nonzero dropout
    rates send the "fused" path to the plain block too. With the same scales
    and no generator (dropout off) all agree with the kernel path."""
    cfg = dataclasses.replace(TINY_SWIN, attention_impl="fused", drop_path_rate=0.2)
    images = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32))
    base = SwinTransformer(cfg)
    from on_device_image_captioning_torch.models.end_to_end import init_weights

    init_weights(base, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(5)
    scales = [(pcommon.drop_path_scale(0.3, 2, g, "cpu"), pcommon.drop_path_scale(0.3, 2, g, "cpu"))
              for _ in range(4)]

    def grads(model):
        model.load_state_dict(base.state_dict())
        y = model(images, train=True, drop_path_scales=scales)
        y.square().mean().backward()
        return y.detach(), [p.grad for p in model.parameters()]

    want_y, want = grads(base)
    for other in (dataclasses.replace(cfg, attention_impl="pallas"),
                  dataclasses.replace(cfg, drop_rate=0.1, attn_drop_rate=0.1)):
        got_y, got = grads(SwinTransformer(other))
        assert_close_to_max(got_y, want_y, STACK_TOL, "tokens")
        assert_all_close_to_max(got, want, [n for n, _ in base.named_parameters()], STACK_TOL)
    with pytest.raises(ValueError, match="one per block"):
        base(images, train=True, drop_path_scales=scales[:3])


def _xe_pair(seed, swin_overrides=None):
    swin = dataclasses.replace(TINY_SWIN, attention_impl="fused", drop_path_rate=0.1,
                               **(swin_overrides or {}))
    cap = dataclasses.replace(
        TINY_CAP, vocab_size=64, img_feature_dim=swin.num_features, N_enc=1, N_dec=1,
        num_exp_enc_list=(4,),
        drop=pcfg.DropConfig(enc=0.0, dec=0.0, enc_input=0.0, dec_input=0.0, other=0.0))
    cfg = pcfg.ModelConfig(swin=swin, captioner=cap)
    jcfg = to_jax_model(cfg)
    params = je2e.init(jax.random.PRNGKey(seed), jcfg)
    model = EndExpansionNetV2(cfg)
    model.load_state_dict(state_dict_from_jax(numpy_tree(params), cfg), strict=True)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    captions = rng.integers(4, 64, (2, 8)).astype(np.int32)
    captions[:, 0] = cap.sos_idx
    captions[1, 6:] = cap.pad_idx  # a right-padded caption
    return cfg, jcfg, params, model, images, captions


def test_xe_step_matches_jax():
    """Loss, every gradient, and the parameters after one optimizer step of
    `make_xe_step` (PlainRAdam: RAdam's first steps are no-ops by design),
    with the JAX side's stochastic-depth scales handed to the port."""
    cfg, jcfg, params, model, images, captions = _xe_pair(0)
    key = jax.random.PRNGKey(11)
    batch = {"enc_input": jnp.asarray(images), "captions": jnp.asarray(captions)}

    # one jitted JAX step of `make_xe_step`, with an optimizer that notes the
    # gradients it is handed (returned from the same trace) and then updates as
    # PlainRAdam does
    lr = 1e-2
    inner, seen = jradam.plain_radam(lr), []

    def update(grads, state, params_):
        seen.append(grads)
        return inner.update(grads, state, params_)

    optimizer = optax.GradientTransformation(inner.init, update)
    state = jstep.init_train_state(params, optimizer)
    xe_step = jstep.make_xe_step(jcfg, optimizer, True)
    new_state, metrics, want_grads = jax.jit(
        lambda st, ba, k: (*xe_step(st, ba, k), seen.pop()))(state, batch, key)
    want_loss = metrics["loss"]

    swin_key = jax.random.split(jax.random.split(key)[0])[0]  # forward -> forward_enc -> swin
    scales = jax_drop_path_scales(jcfg.swin, swin_key, 2)
    pbatch = {"enc_input": torch.from_numpy(images), "captions": torch.from_numpy(captions)}
    loss = pstep.xe_loss(model, cfg, pbatch, drop_path_scales=scales)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=STACK_TOL)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = pstep.make_xe_step(model, cfg, pradam.PlainRAdam(model.parameters(), lr))
    out = step(pbatch, drop_path_scales=scales)
    np.testing.assert_allclose(float(out["loss"]), float(want_loss), rtol=STACK_TOL)
    _compare_trees(_tree_grads(model, convert_end_to_end, jcfg), want_grads, STACK_TOL)
    # the update is -lr * g on the first step: hold the parameters' movement
    moved = {n: p.detach() - before[n] for n, p in model.named_parameters()}
    want_moved = jax.tree.map(lambda a, b: a - b, new_state.params, params)
    _compare_trees(convert_end_to_end(moved, jcfg), want_moved, STACK_TOL)
    _compare_trees(convert_end_to_end(dict(model.state_dict()), jcfg), new_state.params, 1e-6)


def test_xe_steps_decrease_loss_and_uint8_images():
    """Ten XE steps on one tiny batch lower the loss, with dropout and
    stochastic depth drawn from a generator, on uint8 images."""
    swin = dataclasses.replace(TINY_SWIN, attention_impl="fused", drop_path_rate=0.1)
    cap = dataclasses.replace(TINY_CAP, vocab_size=64, img_feature_dim=swin.num_features)
    cfg = pcfg.ModelConfig(swin=swin, captioner=cap)
    from on_device_image_captioning_torch.models.end_to_end import init_weights

    model = init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"enc_input": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "captions": torch.from_numpy(rng.integers(4, 64, (2, 7)))}
    step = pstep.make_xe_step(model, cfg, pradam.PlainRAdam(model.parameters(), 1e-2))
    g = torch.Generator().manual_seed(1)
    losses = [float(step(batch, g)["loss"]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


# ---------------------------------------------------------------------------
# optimizer, schedules, loss, dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_radam_trajectory_matches_jax(plain, weight_decay):
    """25 steps on three small tensors with numpy gradients, lr from a
    schedule: the no-step gate (N_sma < 5), the SGD fallback and the
    rectified branch all occur. The JAX side forms N_sma = 1999 - 2 t b2^t /
    (1 - b2^t) in fp32, where the difference cancels three digits (about 1e-3
    relative in the rectification factor early on); the port computes the
    step's scalars in Python floats, as the reference's optimizer does. With
    lr 5e-3 that is a few 1e-6 a step on parameters of size 1: atol 5e-5."""
    rng = np.random.default_rng(80)
    shapes = [(5, 7), (11,), (2, 3, 4)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(25)]
    sched_args = (5e-3, 4, 2.0, 5)
    make = jradam.plain_radam if plain else jradam.radam
    jopt = make(jsched.annealing(*sched_args), weight_decay=weight_decay)
    jparams = [jnp.asarray(a) for a in init]
    jstate = jopt.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    cls = pradam.PlainRAdam if plain else pradam.RAdam
    opt = cls(params, psched.annealing(*sched_args), weight_decay=weight_decay)
    for t, gs in enumerate(grads):
        updates, jstate = jopt.update([jnp.asarray(g) for g in gs], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=2e-5, atol=5e-5,
                                       err_msg=f"step {t}")
    assert opt.count == 25 and any(float((p.detach() - torch.from_numpy(a)).abs().max()) > 1e-3
                                   for p, a in zip(params, init))


def test_schedules_match_jax():
    steps = list(range(0, 60, 3)) + [1000, 12345]
    for name, args in (("annealing", (2e-4, 10, 1.5, 7)), ("annealing", (1.0, 1, 2.0, 100, 0.5)),
                       ("custom_warmup_anneal", (3e-5, 20, 1e-6, 0.9, 2.0, 4))):
        want, got = getattr(jsched, name)(*args), getattr(psched, name)(*args)
        for s in steps:
            # atol: the JAX side's fp32 underflows to 0 where 0.5^123 is 1e-37 here
            np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-5, atol=1e-30,
                                       err_msg=f"{name} {s}")


@pytest.mark.parametrize("divide", [True, False])
def test_label_smoothing_loss_matches_jax(divide):
    rng = np.random.default_rng(90)
    logits = (3.0 * rng.standard_normal((3, 6, 40))).astype(np.float32)
    targets = rng.integers(1, 40, (3, 6)).astype(np.int32)
    targets[0, 4:] = 0
    targets[2, 1:] = 0
    want, want_g = jax.value_and_grad(
        lambda l: jlosses.label_smoothing_loss(l, jnp.asarray(targets), 0, 0.1, divide))(
            jnp.asarray(logits))
    pl = torch.from_numpy(logits).requires_grad_()
    got = plosses.label_smoothing_loss(pl, torch.from_numpy(targets), 0, 0.1, divide)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    (got_g,) = torch.autograd.grad(got, pl)
    assert_close_to_max(got_g, want_g, 1e-5, "dlogits")
    all_pad = plosses.label_smoothing_loss(pl, torch.zeros((3, 6), dtype=torch.int64), 0)
    assert float(all_pad) == 0.0  # no non-pad token: 0 / max(0, 1)


def test_scst_loss_and_baseline_match_jax():
    rng = np.random.default_rng(91)
    lp = -np.abs(rng.standard_normal((2, 5, 7))).astype(np.float32)
    r = rng.random((2, 5)).astype(np.float32)
    base = jlosses.mean_baseline(jnp.asarray(r))
    got_base = plosses.mean_baseline(torch.from_numpy(r))
    np.testing.assert_allclose(got_base.numpy(), np.asarray(base), rtol=1e-6)
    np.testing.assert_allclose(
        float(plosses.scst_loss(torch.from_numpy(lp), torch.from_numpy(r), got_base)),
        float(jlosses.scst_loss(jnp.asarray(lp), jnp.asarray(r), base)), rtol=1e-5)


def test_dropout_and_drop_path_scale():
    x = torch.ones((200, 300))
    g = torch.Generator().manual_seed(0)
    assert pcommon.dropout(x, 0.3, False, g) is x  # identity when not training
    assert pcommon.dropout(x, 0.0, True, g) is x  # zero rate
    assert pcommon.dropout(x, 0.3, True, None) is x  # no generator: off, as rng=None there
    y = pcommon.dropout(x, 0.3, True, g)
    assert {round(float(v), 5) for v in np.unique(y.numpy())} == {0.0, round(1 / 0.7, 5)}
    assert abs(float(y.mean()) - 1.0) < 0.02  # mean-preserving
    again = pcommon.dropout(x, 0.3, True, torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, again, rtol=0, atol=0)  # reproducible from the generator
    assert pcommon.dropout(x.bfloat16(), 0.3, True, g).dtype == torch.bfloat16
    m = pcommon.drop_path_scale(0.25, 4000, torch.Generator().manual_seed(2), "cpu")
    assert m.dtype == torch.float32 and m.shape == (4000,)
    assert {round(float(v), 5) for v in np.unique(m.numpy())} == {0.0, round(1 / 0.75, 5)}
    assert abs(float(m.mean()) - 1.0) < 0.05
    assert bool((pcommon.drop_path_scale(0.0, 3, g, "cpu") == 1).all())
    assert bool((pcommon.drop_path_scale(0.5, 3, None, "cpu") == 1).all())


def test_dropout_refuses_a_generator_on_another_device():
    """A generator on the host for tensors elsewhere would draw every mask on
    the host and copy it over: both helpers raise instead."""
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="generator lives on 'cpu'"):
        pcommon.dropout(torch.ones((2, 3), device="meta"), 0.3, True, g)
    with pytest.raises(ValueError, match="generator lives on 'cpu'"):
        pcommon.drop_path_scale(0.25, 4, g, "meta")


def test_grad_accum_matches_optax_multisteps():
    rng = np.random.default_rng(95)
    init = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(6)]
    jopt = jstep.with_grad_accum(jradam.plain_radam(1e-2), 3)
    jp = jnp.asarray(init)
    jstate = jopt.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = pstep.with_grad_accum(pradam.PlainRAdam([p], 1e-2), 3)
    for g in grads:
        updates, jstate = jopt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        (p * torch.from_numpy(g)).sum().backward()  # adds g into p.grad
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=2e-5, atol=2e-6)
    inner = pradam.PlainRAdam([p], 1e-2)
    assert pstep.with_grad_accum(inner, 1) is inner
