"""The launch plans of the stage boundaries on the CPU: B8's
(`ops/linear_plan.py::merge_plan`: the route, the tile form and the K split
over a cluster of the shared product's MERGE form) and B7's (`ops/stage_boundary.py::
embed_plan`: the persistent grid), pure functions of the shapes and the
card's SM count, held to the constants of their C sources; the forward
product's plan (`linear_plan`) unchanged for B4, B5, B10a and B10b at the
main path's shapes; and B8's split order in plain tensor code
(`downsample_split_reference`) held to the plain version and to the JAX
package's kernel."""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.ops import linear_plan as lp
from on_device_image_captioning_torch.ops import stage_boundary as psb
from on_device_image_captioning_tpu.ops import stage_boundary as jsb

H100_SMS = 132
CSRC = pathlib.Path(lp.__file__).resolve().parents[1] / "csrc"
BOUNDARY_SOURCE = (CSRC / "stage_boundary.cu").read_text()
PRODUCT_SOURCE = (CSRC / "fused_linear.cuh").read_text()
# Swin-L/384 stages 0-2: (C, token-grid side)
STAGES = [(192, 96), (384, 48), (768, 24)]


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def _merge(b, stage, itemsize=2, sms=H100_SMS, **kw):
    c, res = STAGES[stage]
    return lp.merge_plan(b * res * res // 4, 2 * c, 4 * c, 4, itemsize, sms, **kw)


# ---------------------------------------------------------------------------
# B8: merge_plan
# ---------------------------------------------------------------------------

# (batch, stage) -> (form, splits) the plan picks on an H100 (132 SMs): the
# main path's six patch mergings (b8 and b1) and the kernel table's B = 2.
# K is split at stage 2 at every batch and wherever the tiles leave CTA
# slots idle; the model is fitted to `cli/product_forms --merge` on an H100
# (PERF.md §6). Unsplit (b8 stages 0 and 1) is the scratch route in
# `linear_plan`'s form, measured faster there than the LayerNorm in the ring.
PINNED = {
    (8, 0): (0, 1), (8, 1): (0, 1), (8, 2): (0, 2),
    (1, 0): (1, 2), (1, 1): (1, 4), (1, 2): (1, 6),
    (2, 0): (0, 2), (2, 1): (0, 4), (2, 2): (1, 4),
}
CASES = sorted(PINNED)
IDS = [f"b{b}-stage{s}" for b, s in CASES]


@pytest.mark.parametrize("b, stage", CASES, ids=IDS)
def test_merge_plan_picks_its_pinned_tile_and_split(b, stage):
    plan = _merge(b, stage)
    assert (plan.form, plan.splits) == PINNED[(b, stage)]
    assert plan.ring == (plan.splits > 1)
    f = lp.FORMS[plan.form]
    assert plan.tile == (f.bm, f.bn) and plan.slab == f.bk
    assert plan.grid == (math.ceil(plan.n / f.bn), math.ceil(plan.m / f.bm), plan.splits)


@pytest.mark.parametrize("b, stage", CASES, ids=IDS)
def test_every_split_covers_k_once_in_order(b, stage):
    """Every (form, splits) the plan takes: the chunks are whole slabs, none
    empty, and laid end to end they are K, once, in rank order; no slab
    straddles two of the four gathered rows."""
    c, _ = STAGES[stage]
    taken = 0
    for form in range(len(lp.FORMS)):
        for splits in lp.MERGE_SPLITS:
            try:
                plan = _merge(b, stage, form=form, splits=splits)
            except ValueError:
                continue
            taken += 1
            chunks = plan.k_chunks()
            assert len(chunks) == splits <= lp.MAX_SPLITS
            assert [k for ch in chunks for k in ch] == list(range(4 * c))
            assert all(len(ch) and ch.start % plan.slab == 0 for ch in chunks)
            for z in range(splits):
                slabs = plan.k_slabs(z)
                assert len(slabs) * plan.slab == len(chunks[z])
                assert all(off + plan.slab <= c for _, off in slabs)
    assert taken >= 3


def test_merge_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        _merge(2, 2, splits=9)  # more than a portable cluster
    with pytest.raises(ValueError):
        _merge(2, 0, splits=6)  # 12 slabs of 64: chunks of 2, fewer than MERGE_MIN_SLABS
    with pytest.raises(ValueError):
        _merge(2, 0, form=3)  # slabs of 32 where 64 divide the gathered row
    with pytest.raises(ValueError):
        _merge(2, 0, itemsize=4, splits=2)  # fp32 does not split K
    with pytest.raises(ValueError):
        lp.merge_plan(64, 2 * 100, 4 * 100, 4, 2, H100_SMS)  # K / segs not a multiple of 32


@pytest.mark.parametrize("b, stage", CASES, ids=IDS)
def test_fp32_merge_runs_the_cuda_cores_tile_unsplit(b, stage):
    plan = _merge(b, stage, itemsize=4)
    assert plan.form == -1 and plan.splits == 1 and plan.tile == lp.FP32_TILE
    assert plan.k_chunks() == [range(plan.k)]


def test_merge_plan_constants_match_the_source():
    """The launcher takes 2 to MAX_SPLITS CTAs a cluster, and the MERGE
    form is the shared product's kernel with its template flag set."""
    assert f"splits < 2 || splits > {lp.MAX_SPLITS}" in PRODUCT_SOURCE
    assert "linear_wgmma_kernel<f.bm, f.bn, f.bk, f.stages, f.ctas, true>" in PRODUCT_SOURCE
    assert max(lp.MERGE_SPLITS) == lp.MAX_SPLITS


def test_merge_routes_match_the_source():
    """The C entry point sends a split plan to the MERGE form and an unsplit
    one (K whole) to ln_rows_kernel and the plain form, as B4 and B5 run."""
    body = BOUNDARY_SOURCE[BOUNDARY_SOURCE.index('extern "C" int downsample_launch'):]
    assert "if (splits > 1) {" in body
    assert "return launch_merge(p, form, splits, prologue_ready != 0, s);" in body
    assert "if (k_chunk != p.K) return cudaErrorInvalidValue;" in body
    assert "return launch_linear_wide<__nv_bfloat16>(p, form, s);" in body


@pytest.mark.parametrize("b, stage", CASES, ids=IDS)
def test_unsplit_merge_takes_the_scratch_route(b, stage):
    """Every unsplit bf16 plan (the plan's pick, or any form given one
    split) is the scratch route: K whole, and without a form given,
    `linear_plan`'s form at the same shapes."""
    plan = _merge(b, stage, splits=1)
    assert not plan.ring and plan.k_chunk == plan.k and plan.k_chunks() == [range(plan.k)]
    assert plan.form == lp.linear_plan(plan.m, plan.n, plan.k, 4, 2, H100_SMS).form
    for form in (0, 1, 2):
        given = _merge(b, stage, form=form, splits=1)
        assert (given.form, given.ring, given.k_chunk) == (form, False, plan.k)


@pytest.mark.parametrize("b", [1, 2, 8])
def test_merge_plan_splits_only_where_tiles_leave_slots_idle(b):
    """A split plan's unsplit form has fewer tiles than the card's CTA
    slots; the split never makes a chunk of fewer than MERGE_MIN_SLABS."""
    for stage in range(3):
        plan = _merge(b, stage)
        f = lp.FORMS[plan.form]
        if plan.splits > 1:
            assert plan.grid[0] * plan.grid[1] < H100_SMS * f.ctas
            assert plan.k_chunk // plan.slab >= lp.MERGE_MIN_SLABS


# ---------------------------------------------------------------------------
# linear_plan: B4, B5, B10a and B10b keep their forms
# ---------------------------------------------------------------------------

# (batch, stage) -> the forms of qkv, proj, fc1, fc2 on an H100: b8 and b1
# (serving: B4 and B5, and B4 under w8a8) and b4 (the XE step: B10a and B10b
# at stage 2), as the plan picked them before B8 left it
LINEAR_FORMS = {
    (8, 0): (0, 0, 0, 0), (8, 1): (0, 0, 0, 0), (8, 2): (0, 0, 0, 0),
    (1, 0): (0, 2, 0, 2), (1, 1): (0, 2, 0, 2), (1, 2): (2, 2, 1, 2),
    (4, 0): (0, 0, 0, 0), (4, 1): (0, 0, 0, 0), (4, 2): (0, 1, 0, 1),
}


@pytest.mark.parametrize("b, stage", sorted(LINEAR_FORMS),
                         ids=[f"b{b}-stage{s}" for b, s in sorted(LINEAR_FORMS)])
def test_linear_plan_keeps_the_blocks_forms(b, stage):
    c, res = STAGES[stage]
    rows = b * res * res
    got = tuple(lp.linear_plan(rows, n, k, 1, 2, H100_SMS).form
                for n, k in ((3 * c, c), (c, c), (4 * c, c), (c, 4 * c)))
    assert got == LINEAR_FORMS[(b, stage)]


# ---------------------------------------------------------------------------
# B7: embed_plan
# ---------------------------------------------------------------------------


def test_embed_plan_constants_match_the_source():
    assert _constant(BOUNDARY_SOURCE, "kEmbedN") == psb.EMBED_N
    assert _constant(BOUNDARY_SOURCE, "kEmbedRows") == psb.EMBED_ROWS
    assert _constant(BOUNDARY_SOURCE, "kEmbedCtas") == psb.EMBED_CTAS
    assert _constant(BOUNDARY_SOURCE, "kEmbedMaxK") == psb.EMBED_MAX_K


@pytest.mark.parametrize("b, ctas", [(1, 144), (2, 288), (8, 384), (3, 216)])
def test_embed_plan_spreads_tiles_evenly(b, ctas):
    """As few CTAs as keep the rounds of the card's slots: every tile once,
    each CTA's count within one of every other's."""
    rows = b * 96 * 96
    plan = psb.embed_plan(rows, 48, 192, 2, H100_SMS)
    assert plan.tiles == math.ceil(rows / psb.EMBED_ROWS) and plan.ctas == ctas
    walked = [t for cta in range(plan.ctas) for t in plan.tiles_of(cta)]
    assert sorted(walked) == list(range(plan.tiles))
    counts = [len(plan.tiles_of(cta)) for cta in range(plan.ctas)]
    assert max(counts) - min(counts) <= 1
    assert max(counts) == math.ceil(plan.tiles / (H100_SMS * psb.EMBED_CTAS))


@pytest.mark.parametrize("k, c, itemsize", [(48, 192, 4), (48, 128, 2), (80, 192, 2),
                                            (40, 192, 2)])
def test_embed_plan_sends_other_shapes_to_the_cuda_cores(k, c, itemsize):
    assert psb.embed_plan(4608, k, c, itemsize, H100_SMS).ctas == 0


# ---------------------------------------------------------------------------
# B8's split order in plain tensor code
# ---------------------------------------------------------------------------

C, WINDOW, N, W_IN, EPS = 64, 4, 16, 4, 1e-5  # 4C = 256: four slabs of 64


def _merge_operands(dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * W_IN * W_IN, N, C)).astype(np.float32)
    g = (1.0 + 0.2 * rng.standard_normal(4 * C)).astype(np.float32)
    b = (0.2 * rng.standard_normal(4 * C)).astype(np.float32)
    w = (rng.standard_normal((4 * C, 2 * C)) / np.sqrt(4 * C)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    return (t(x).to(dtype), (t(g), t(b)), t(w).to(dtype)), (x, g, b, w)


def _split_plans():
    m = 2 * W_IN * W_IN * N // 4
    plans = []
    for form in (0, 1, 2):
        for splits in (1, 2, 4):
            f = lp.FORMS[form]
            plans.append(lp.MergePlan(m, 2 * C, 4 * C, 4, form, (f.bm, f.bn), f.bk,
                                      4 * C // splits, (1, 1, splits)))
    return plans


@pytest.mark.parametrize("plan", _split_plans(), ids=lambda p: f"form{p.form}x{p.splits}")
@pytest.mark.parametrize("dtype, tol", [(torch.float32, dict(rtol=2e-5, atol=2e-5)),
                                        (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))])
def test_split_order_matches_the_plain_version(plan, dtype, tol):
    """The kernel's order (each split's chunk summed in fp32, the partials
    added in rank order, rounded once) against the plain version's single
    product: fp32 sums in another order only."""
    (x, norm, w), _ = _merge_operands(dtype, 5 + plan.splits)
    got = psb.downsample_split_reference(x, norm, w, W_IN, WINDOW, EPS, plan)
    want = psb.downsample_reference(x, norm, w, W_IN, WINDOW, EPS)
    assert got.dtype == dtype and got.shape == want.shape == (8, N, 2 * C)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **tol)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_split_order_matches_the_jax_kernel(splits):
    """... and so the JAX package's `downsample_fused` (its Pallas kernel in
    interpret mode), fp32 2e-5."""
    (x, norm, w), (xn, g, b, wn) = _merge_operands(torch.float32, 11)
    plan = next(p for p in _split_plans() if p.form == 0 and p.splits == splits)
    got = psb.downsample_split_reference(x, norm, w, W_IN, WINDOW, EPS, plan)
    want = jsb.downsample_fused(jnp.asarray(xn), {"scale": jnp.asarray(g), "bias": jnp.asarray(b)},
                                {"w": jnp.asarray(wn)}, W_IN, WINDOW, EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
