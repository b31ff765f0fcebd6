"""The port's kernel modules against the JAX package, on the CPU.

Each wrapper under `on_device_image_captioning_torch/ops/` gets its plain
PyTorch version for a CPU tensor; these tests hold that plain version to the
JAX Pallas kernel it replaces (interpret mode on the CPU) and to the JAX XLA
path. Tolerances: fp32 1e-5 (single ops, summation order only); bf16 one bf16
ulp (2^-8 relative) where both sides round to bf16 at the same points.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from on_device_image_captioning_torch.ops import _cases as pcases
from on_device_image_captioning_torch.ops import dyn_exp_step as pk2
from on_device_image_captioning_torch.ops import layernorm as pk4
from on_device_image_captioning_torch.ops import masks as pmasks
from on_device_image_captioning_torch.ops import topk as pk3
from on_device_image_captioning_torch.ops import window_attention as pk1
from on_device_image_captioning_tpu.models import common as jcommon
from on_device_image_captioning_tpu.ops import masks as jmasks
from on_device_image_captioning_tpu.ops.dyn_exp_step import dyn_exp_step_pallas
from on_device_image_captioning_tpu.ops.layernorm import layernorm_pallas
from on_device_image_captioning_tpu.ops.swin_block_fused import attention_core_fused
from on_device_image_captioning_tpu.ops.topk import topk_pallas
from on_device_image_captioning_tpu.ops.window_attention import window_attention_pallas

F32_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, summation order only
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 ulp is 2^-8 relative


def t(a, dtype=None):
    x = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return x if dtype is None else x.to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, dtype=np.float32)).astype(dtype)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# K4: LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 33), (2, 12, 192), (130, 64), (3, 3072)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_reference_matches_pallas_and_xla(shape, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = pk4.layernorm_reference(t(x, td), t(w), t(b), 1e-5)
    assert got.dtype == td and got.shape == shape
    pallas = layernorm_pallas(j(x, jd), j(w), j(b), 1e-5)
    xla = jcommon.layernorm({"scale": j(w), "bias": j(b)}, j(x, jd))
    np.testing.assert_allclose(as_np(got), as_np(pallas), **tol)
    np.testing.assert_allclose(as_np(got), as_np(xla), **tol)


# ---------------------------------------------------------------------------
# K1: window attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_reference_matches_pallas_and_fused_core(with_mask, dtype):
    """Flat-layout plain version vs window_attention_pallas (per-head q/k/v
    layout) and attention_core_fused (the same flat layout)."""
    rng = np.random.default_rng(0)
    bw, h, n, dk, nw = 6, 2, 16, 8, 3
    c = h * dk
    qkv = rng.standard_normal((bw, n, 3 * c)).astype(np.float32)
    bias = rng.standard_normal((h, n, n)).astype(np.float32)
    mask = np.where(rng.random((nw, n, n)) > 0.8, -100.0, 0.0).astype(np.float32)
    mask = mask if with_mask else None
    scale = dk**-0.5
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL

    got = pk1.window_attention_reference(
        t(qkv, td), t(bias), None if mask is None else t(mask), h, scale
    )
    assert got.dtype == td and got.shape == (bw, n, c)
    # per-head layout for window_attention_pallas: (BW, H, N, dk)
    split = qkv.reshape(bw, n, 3, h, dk).transpose(2, 0, 3, 1, 4)
    want = window_attention_pallas(
        j(split[0], jd), j(split[1], jd), j(split[2], jd), j(bias),
        None if mask is None else j(mask), scale, nw if mask is not None else 1,
    )
    want = as_np(want).transpose(0, 2, 1, 3).reshape(bw, n, c)
    np.testing.assert_allclose(as_np(got), want, **tol)
    if dtype == "float32":  # the fused core scales q in the input dtype; fp32 only
        core = attention_core_fused(
            j(qkv), j(bias), None if mask is None else j(mask), h,
            nw if mask is not None else 1, scale,
        )
        np.testing.assert_allclose(as_np(got), as_np(core), **F32_TOL)


# ---------------------------------------------------------------------------
# K2: dynamic-expansion decode step
# ---------------------------------------------------------------------------

_jit_dyn = jax.jit(dyn_exp_step_pallas, static_argnames=("eps",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dyn_exp_step_reference_matches_pallas(dtype, shuffle):
    """Plain step vs dyn_exp_step_pallas at several positions, identity and
    shuffled (with duplicated source rows) reorders: the output and all six
    new caches."""
    rng = np.random.default_rng(5)
    b, L, E, d = 4, 9, 4, 32
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    # round every cache-dtype input once so both sides start from equal values
    def rnd(a):
        return as_np(t(a, td))

    src = [rnd(arr(b, L, d)) for _ in range(4)] + [rnd(arr(b, L, E, d)) for _ in range(2)]
    for pos in (0, 3, L - 1):
        q_i, bias_i = rnd(arr(b, E, d)), rnd(arr(b, E, d))
        k_i, ca_i, cb_i, cond_i = (rnd(arr(b, d)) for _ in range(4))
        sel = 1.0 / (1.0 + np.exp(-arr(b, d)))
        embed = rnd(arr(E, d))
        reorder = (rng.integers(0, b, b) if shuffle else np.arange(b)).astype(np.int32)

        want = _jit_dyn(
            jnp.int32(pos), j(q_i, jd), j(bias_i, jd), j(k_i, jd), j(ca_i, jd),
            j(cb_i, jd), j(cond_i, jd), j(sel), j(embed, jd),
            *(j(s, jd) for s in src), eps=1e-9, reorder=jnp.asarray(reorder),
        )
        tsrc = [t(s, td) for s in src]
        dst = [torch.empty_like(s) for s in tsrc]
        out = pk2.dyn_exp_step(
            pos, torch.from_numpy(reorder), t(q_i, td), t(bias_i, td), t(k_i, td),
            t(ca_i, td), t(cb_i, td), t(cond_i, td), t(sel), t(embed, td), tsrc, dst,
            eps=1e-9,
        )
        assert out.dtype == torch.float32
        np.testing.assert_allclose(as_np(out), as_np(want[0]), err_msg=f"pos {pos}", **tol)
        for name, got_c, want_c in zip(("keys", "ca", "cb", "cond", "va", "vb"), dst, want[1:]):
            np.testing.assert_allclose(
                as_np(got_c), as_np(want_c), err_msg=f"{name} pos {pos}", **tol
            )
        src = [as_np(c) for c in dst]  # next position continues the written caches


# ---------------------------------------------------------------------------
# K3: top-k
# ---------------------------------------------------------------------------

_jit_topk = jax.jit(topk_pallas, static_argnames=("k",))


def _assert_topk_equal(x, k, dtype=jnp.float32):
    want_v, want_i = _jit_topk(jnp.asarray(x).astype(dtype), k)
    tx = torch.from_numpy(np.asarray(x, np.float32))
    if dtype == jnp.bfloat16:
        tx = tx.to(torch.bfloat16)
    got_v, got_i = pk3.topk_reference(tx, k)
    assert got_i.dtype == torch.int32 and got_v.dtype == tx.dtype
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))  # exact
    np.testing.assert_array_equal(as_np(got_v), as_np(want_v))  # exact (NaN == NaN)


@pytest.mark.parametrize("trial", range(4))
def test_topk_reference_matches_pallas_on_tie_fuzz(trial):
    """Few distinct values force dense exact ties; ties go to the lowest index."""
    rng = np.random.default_rng(100 + trial)
    rows = int(rng.integers(2, 9))
    v = int(rng.choice([1024, 2048, 4096]))
    k = int(rng.integers(1, 9))
    levels = rng.standard_normal(4).astype(np.float32)
    x = levels[rng.integers(0, 4, (rows, v))]
    _assert_topk_equal(x, k)
    _assert_topk_equal(x, k, jnp.bfloat16)


def test_topk_reference_matches_pallas_on_planted_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 2048)).astype(np.float32)
    x[:, 100] = x[:, 7]
    x[:, 200] = x.max(axis=1)
    x[:, 900] = x.max(axis=1)
    for k in (1, 3, 5, 8):
        _assert_topk_equal(x, k)


def test_topk_reference_matches_pallas_on_degenerate_and_nan_rows():
    """Rows with fewer than k finite values return distinct ascending indices
    for the -inf tail; NaN rows follow the kernel's lowest-unchosen rule."""
    v, k = 2048, 5
    x = np.full((6, v), -np.inf, dtype=np.float32)
    x[1, 10] = 3.0
    x[2, 5], x[2, 17] = 1.0, 2.0
    x[4] = np.linspace(-1, 1, v, dtype=np.float32)
    x[4, 3] = np.nan  # NaN early: 0..3 sequential, then the sorted tail
    x[5] = np.linspace(1, -1, v, dtype=np.float32)
    x[5, 1], x[5, 1500] = np.nan, np.nan  # a NaN past k: all picks sequential
    _assert_topk_equal(x, k)
    _assert_topk_equal(x[4:], 2)


def test_topk_routes_to_plain_on_cpu():
    x = torch.randn(3, 2048)
    before = pk3.launches
    v, i = pk3.topk(x, 3)
    want_v, want_i = pk3.topk_reference(x, 3)
    assert torch.equal(i, want_i) and torch.equal(v, want_v)
    assert pk3.launches == before
    # a tensor the dispatcher has no kernel of `odic::topk` for is refused there
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        pk3.topk(x.to_sparse(), 3)
    assert pk3.launches == before


def test_case_compare_matches_nan_and_inf_and_applies_tolerance():
    """The comparison the card checks use (ops/_cases.py): NaN matches NaN,
    an infinity matches the same infinity, and |got - want| <= atol + rtol
    |want| elementwise; shapes must agree."""
    nan, inf = float("nan"), float("inf")
    assert pcases.compare(torch.tensor([nan, -inf, 1.0]), torch.tensor([nan, -inf, 1.0]),
                          (0.0, 0.0))[2]
    assert not pcases.compare(torch.tensor([nan]), torch.tensor([0.0]), (1.0, 1.0))[2]
    assert not pcases.compare(torch.tensor([inf]), torch.tensor([-inf]), (1.0, 1.0))[2]
    assert pcases.compare(torch.tensor([1.0]), torch.tensor([1.1]), (0.05, 0.05))[2]
    assert not pcases.compare(torch.tensor([1.0]), torch.tensor([1.1]), (0.05, 0.0))[2]
    assert not pcases.compare(torch.zeros(2), torch.zeros(3), (1.0, 1.0))[2]


def test_case_compare_takes_an_elementwise_slack():
    """A (atol, rtol, slack) tolerance adds the slack tensor elementwise to
    atol + rtol |want|; `slack_used` counts the elements that need it."""
    got, want = torch.tensor([1.0, 0.0, 5.0]), torch.tensor([1.0, 0.1, 5.2])
    tol = (0.05, 0.0, torch.tensor([0.0, 0.06, 0.2]))
    assert pcases.compare(got, want, tol)[2] and pcases.slack_used(got, want, tol) == 2
    tight = (0.05, 0.0, torch.tensor([0.0, 0.04, 0.2]))
    assert not pcases.compare(got, want, tight)[2]
    assert pcases.slack_used(got, want, (0.05, 0.0)) == 0


def test_bf16_ulp_of_the_addends():
    """`_ulp_bf16`: the spacing of bf16 values at |t| (2^-7 relative to the
    power of two below), 0 at 0; one ulp up from a bf16 value is the next."""
    t = torch.tensor([1.0, -1.5, 2.0, 0.75, 0.0, 3e-3])
    want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 2.0 ** -8, 0.0, 2.0 ** -16])
    assert torch.equal(pcases._ulp_bf16(t), want)
    b = torch.randn(1000, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    up = (b.float().abs() + pcases._ulp_bf16(b)).to(torch.bfloat16)
    nxt = torch.nextafter(b.float().abs().to(torch.bfloat16), torch.tensor(float("inf"),
                                                                          dtype=torch.bfloat16))
    assert torch.equal(up, nxt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whole_block_plain_addends_sum_to_its_output(dtype):
    """The B6 check's plain side (ops/_cases.py `_block_plain`): x1 (B4's plain
    version) plus the MLP branch is `swin_block_reference`'s output, bit for
    bit, with the mask and the transition."""
    from on_device_image_captioning_torch.models.swin import shift_attn_mask
    from on_device_image_captioning_torch.ops import swin_block_fused as sbf

    g = torch.Generator().manual_seed(7)
    c, heads, res, win = 64, 2, 8, 4
    rn = lambda *shape, s=1.0: (torch.randn(shape, generator=g) * s)  # noqa: E731
    x = rn(8, 16, c).to(dtype)
    norm1, norm2 = (rn(c, s=0.2) + 1, rn(c, s=0.2)), (rn(c, s=0.2) + 1, rn(c, s=0.2))
    lin = lambda k, n: (rn(k, n, s=k ** -0.5).to(dtype), rn(n, s=0.2))  # noqa: E731
    mask = torch.from_numpy(shift_attn_mask(res, win, 2))
    a = (x, norm1, lin(c, 3 * c), lin(c, c), norm2, lin(c, 4 * c), lin(4 * c, c),
         rn(heads, 16, 16, s=0.5), mask, heads, 32 ** -0.5, 1e-5, (res, 0, 2))
    out, x1, branch = pcases._block_plain(a)
    assert torch.equal(out, sbf.swin_block_reference(*a))
    assert torch.equal(x1, sbf.swin_attn_half_reference(*a[:4], *a[7:]))
    assert torch.equal(x1 + branch, sbf.swin_mlp_half_reference(x1, *a[4:7], 1e-5))


# ---------------------------------------------------------------------------
# masks and CPU dispatch
# ---------------------------------------------------------------------------


def test_masks_match_jax():
    pads = np.array([0, 2, 5], np.int32)
    np.testing.assert_array_equal(
        pmasks.pad_mask(3, 4, 6, col_pads=torch.from_numpy(pads)).numpy(),
        np.asarray(jmasks.pad_mask(3, 4, 6, col_pads=jnp.asarray(pads))),
    )
    np.testing.assert_array_equal(
        pmasks.pad_mask(3, 6, 6, torch.from_numpy(pads), torch.from_numpy(pads)).numpy(),
        np.asarray(jmasks.pad_mask(3, 6, 6, jnp.asarray(pads), jnp.asarray(pads))),
    )
    np.testing.assert_array_equal(
        pmasks.causal_pad_mask(3, 6, torch.from_numpy(pads)).numpy(),
        np.asarray(jmasks.causal_pad_mask(3, 6, jnp.asarray(pads))),
    )
    m = np.random.default_rng(0).random((2, 3, 4)) > 0.5
    np.testing.assert_array_equal(
        pmasks.expand_mask_rows(torch.from_numpy(m), 3).numpy(),
        np.asarray(jmasks.expand_mask_rows(jnp.asarray(m), 3)),
    )
    np.testing.assert_array_equal(
        pmasks.expand_mask_cols(torch.from_numpy(m), 3).numpy(),
        np.asarray(jmasks.expand_mask_cols(jnp.asarray(m), 3)),
    )


def test_wrappers_use_plain_versions_on_cpu_and_count_nothing():
    rng = np.random.default_rng(1)
    counters = [m.launches for m in (pk1, pk2, pk3, pk4)]
    x = t(rng.standard_normal((5, 64)))
    w, b = t(rng.standard_normal(64)), t(rng.standard_normal(64))
    assert torch.equal(pk4.layernorm(x, w, b), pk4.layernorm_reference(x, w, b))
    qkv = t(rng.standard_normal((2, 16, 48)))
    bias = t(rng.standard_normal((2, 16, 16)))
    assert torch.equal(
        pk1.window_attention(qkv, bias, None, 2, 0.25),
        pk1.window_attention_reference(qkv, bias, None, 2, 0.25),
    )
    assert [m.launches for m in (pk1, pk2, pk3, pk4)] == counters
