"""The launch plan of the backbone's shared bf16 product
(`ops/linear_plan.py::linear_plan`, which the wrappers of B4, B5, B9b and
B10a / B10b hand to `csrc/fused_linear.cuh`; B8's plan is
`tests/test_torch_stage_plan.py`'s) on the CPU: a pure function of the
shapes and the card's SM count, so these run without a card."""
import pathlib
import re

import pytest

from on_device_image_captioning_torch.ops import linear_plan as lp

H100_SMS = 132
# Swin-L/384 stages 0-2: (C, token-grid side)
STAGES = [(192, 96), (384, 48), (768, 24)]
BATCHES = [1, 2, 8, 32]  # latency, the kernel table's B = 2, serve, evaluation


def _products():
    """(label, M, N, K, segs) of every product of the main path's blocks
    (qkv, proj, fc1, fc2) and downsamples (the 2x2 merge: four segments)."""
    out = []
    for b in BATCHES:
        for stage, (c, res) in enumerate(STAGES):
            m = b * res * res
            for name, n, k in (("qkv", 3 * c, c), ("proj", c, c), ("fc1", 4 * c, c),
                               ("fc2", c, 4 * c)):
                out.append((f"b{b} stage{stage} {name}", m, n, k, 1))
            out.append((f"b{b} downsample{stage}", m // 4, 2 * c, 4 * c, 4))
    return out


PRODUCTS = _products()
IDS = [p[0] for p in PRODUCTS]


def _plan(m, n, k, segs, itemsize=2, sms=H100_SMS):
    return lp.linear_plan(m, n, k, segs, itemsize, sms)


def _partition(spans, size):
    """Whether the ranges cover 0 .. size - 1 exactly once."""
    seen = sorted(i for r in spans for i in (r.start, r.stop))
    starts = sorted(r.start for r in spans if len(r))
    ends = sorted(r.stop for r in spans if len(r))
    return (sum(len(r) for r in spans) == size and starts[0] == 0 and ends[-1] == size
            and starts[1:] == ends[:-1] and len(seen) == 2 * len(spans))


@pytest.mark.parametrize("label, m, n, k, segs", PRODUCTS, ids=IDS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_covers_every_output_tile_once(label, m, n, k, segs, itemsize):
    """The grid's tiles partition the M x N output: the row tiles partition M,
    the column tiles N, and no CTA's tile is empty."""
    plan = _plan(m, n, k, segs, itemsize)
    rows = [plan.tile_span(0, by)[0] for by in range(plan.grid[1])]
    cols = [plan.tile_span(bx, 0)[1] for bx in range(plan.grid[0])]
    assert _partition(rows, m) and _partition(cols, n)
    assert all(len(r) for r in rows) and all(len(c) for c in cols)
    assert plan.ctas == len(rows) * len(cols)


@pytest.mark.parametrize("label, m, n, k, segs", PRODUCTS, ids=IDS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_walks_every_k_slab_once_in_order(label, m, n, k, segs, itemsize):
    """K is not split: every CTA walks all of K in slabs, in order, each slab
    inside one gathered row (segment) of K / segs."""
    plan = _plan(m, n, k, segs, itemsize)
    ks = k // segs
    flat = [seg * ks + off for seg, off in plan.k_slabs()]
    assert flat == list(range(0, k, plan.slab))
    assert all(off + plan.slab <= ks for _, off in plan.k_slabs())
    assert [s for s, _ in plan.k_slabs()] == sorted(s for s, _ in plan.k_slabs())


@pytest.mark.parametrize("label, m, n, k, segs", PRODUCTS, ids=IDS)
def test_plan_fits_shared_memory(label, m, n, k, segs):
    """The chosen form's shared memory fits a CTA (232,448 bytes) and, at its
    CTAs an SM, the SM (233,472, 1 KB of it reserved for each CTA)."""
    f = lp.FORMS[_plan(m, n, k, segs).form]
    assert f.shared_bytes <= lp.CTA_SHARED == 232448
    assert f.ctas * (f.shared_bytes + 1024) <= lp.SM_SHARED


@pytest.mark.parametrize("label, m, n, k, segs", PRODUCTS, ids=IDS)
def test_plan_fills_one_wave_where_the_shapes_allow(label, m, n, k, segs):
    """At least one CTA an SM wherever the smallest tile gives the card that
    many; otherwise the smallest tile's count."""
    plan = _plan(m, n, k, segs)
    smallest = min(-(-m // f.bm) * -(-n // f.bn) for f in lp.FORMS
                   if (k // segs) % f.bk == 0)
    assert plan.ctas >= min(H100_SMS, smallest)


@pytest.mark.parametrize("sms", [132, 114, 66, 16])
def test_plan_follows_the_cards_sm_count(sms):
    """The wave comes from the card's SM count: the b1 stage-2 products fill
    a smaller card too, each output tile still covered once."""
    for name, n, k in (("qkv", 2304, 768), ("fc2", 768, 3072)):
        plan = _plan(576, n, k, 1, sms=sms)
        assert plan.ctas >= min(sms, 108), name
        assert plan.grid == (-(-n // plan.tile[1]), -(-576 // plan.tile[0]))


@pytest.mark.parametrize("m, n, k, segs", [(577, 768, 768, 1), (1153, 2304, 768, 1),
                                           (592, 3072, 768, 1), (1, 8, 32, 1), (7, 24, 96, 1),
                                           (144, 1536, 3072, 4), (100, 64, 128, 4)])
def test_plan_takes_ragged_shapes(m, n, k, segs):
    """Shapes off the main path that the product takes (M >= 1, N a multiple
    of 8, K / segs of 32): the last tiles are partial, and a gathered row of an
    odd multiple of 32 gets the form with slabs of 32."""
    plan = _plan(m, n, k, segs)
    assert plan.grid == (-(-n // plan.tile[1]), -(-m // plan.tile[0]))
    assert (k // segs) % plan.slab == 0
    assert (plan.slab == 32) == ((k // segs) % 64 != 0)


@pytest.mark.parametrize("m, n, k, segs, match", [
    (576, 772, 768, 1, "multiple of 8"),     # N % 8
    (576, 4, 768, 1, "unsupported shapes"),  # N < 8
    (576, 768, 784, 1, "multiple of 32"),    # K % 32
    (144, 1536, 3056, 4, "multiple of 32"),  # K / segs % 32
    (144, 1536, 3074, 4, "multiple of 32"),  # K % segs
    (0, 768, 768, 1, "unsupported shapes"),  # no rows
    (576, 768, 768, 5, "unsupported shapes"),  # segs beyond 4
])
def test_plan_raises_outside_the_kernels_shapes(m, n, k, segs, match):
    for itemsize in (2, 4):
        with pytest.raises(ValueError, match=match):
            _plan(m, n, k, segs, itemsize)


def test_forms_mirror_the_kernels_table():
    """FORMS is `kProductForms` of csrc/fused_linear.cuh, row for row, and its
    shared-memory formula `product_smem` (both read from the source)."""
    src = (pathlib.Path(lp.__file__).resolve().parents[1] / "csrc" / "fused_linear.cuh").read_text()
    table = src[src.index("kProductForms[] = {"):]
    table = table[:table.index("};")]
    rows = re.findall(r"\{(\d+), (\d+), (\d+), (\d+), (\d+)\},\s*// (\d+)", table)
    assert [tuple(int(v) for v in r[:5]) for r in rows] == [
        (f.bm, f.bn, f.bk, f.stages, f.ctas) for f in lp.FORMS]
    assert [int(r[5]) for r in rows] == list(range(len(lp.FORMS)))
    smem = src[src.index("constexpr int product_smem("):]
    smem = smem[:smem.index("}")]
    expr = " ".join(smem[smem.index("return") + len("return"):smem.index(";")].split())
    for f in lp.FORMS:
        got = eval(expr.replace("f.", "F_"), {}, {  # noqa: S307 - our own source
            "F_bm": f.bm, "F_bn": f.bn, "F_bk": f.bk, "F_stages": f.stages})
        assert got == f.shared_bytes


def test_fp32_plan_is_the_cuda_cores_tile():
    plan = _plan(4608, 768, 3072, 1, itemsize=4)
    assert (plan.form, plan.tile, plan.slab) == (-1, lp.FP32_TILE, lp.FP32_SLAB)
