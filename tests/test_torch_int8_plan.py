"""The launch plan of the w8a8 MLP half's int8 products
(`ops/linear_plan.py::int8_plan` and `mlp_a8_plan`, which the wrapper of B13
hands to `csrc/swin_mlp_half_a8.cu`) on the CPU: a pure function of the
shapes and the card's SM count, so these run without a card. Also the plain
version of B13's products alone (`mlp_a8_product` on CPU tensors), held to
the plain version of the whole half."""
import pathlib
import re

import pytest
import torch

from on_device_image_captioning_torch.ops import linear_plan as lp
from on_device_image_captioning_torch.ops import quant_matmul as qm
from on_device_image_captioning_torch.ops import swin_block_fused as sbf

H100_SMS = 132
# Swin-L/384 stages 0-2: (C, token-grid side)
STAGES = [(192, 96), (384, 48), (768, 24)]
BATCHES = [1, 2, 8]  # latency, the kernel table's B = 2, serve


def _products():
    """(label, M, N, K) of both products of every w8a8 MLP half of the main
    path: fc1 (C -> 4C) and fc2 (4C -> C), K = 192 at stage 0 (a slab and a
    half) and N = 192 there."""
    out = []
    for b in BATCHES:
        for stage, (c, res) in enumerate(STAGES):
            m = b * res * res
            out.append((f"b{b} stage{stage} fc1", m, 4 * c, c))
            out.append((f"b{b} stage{stage} fc2", m, c, 4 * c))
    return out


PRODUCTS = _products()
IDS = [p[0] for p in PRODUCTS]
SOURCE = pathlib.Path(lp.__file__).resolve().parents[1] / "csrc" / "swin_mlp_half_a8.cu"


def _plan(m, n, k, sms=H100_SMS, form=None):
    return lp.int8_plan(m, n, k, sms, form)


def _partition(spans, size):
    """Whether the ranges cover 0 .. size - 1 exactly once, in order."""
    flat = [i for r in spans for i in r]
    return flat == list(range(size))


@pytest.mark.parametrize("label, m, n, k", PRODUCTS, ids=IDS)
@pytest.mark.parametrize("form", [None, 0, 1, 2])
def test_plan_covers_every_output_tile_once(label, m, n, k, form):
    """The one-dimensional grid's CTAs, column tiles fastest, partition the
    M x N output: every (row tile, column tile) once, none empty."""
    plan = _plan(m, n, k, form=form)
    tiles = {plan.tile_of(i) for i in range(plan.ctas)}
    assert len(tiles) == plan.ctas == plan.grid[0] * plan.grid[1]
    rows = [plan.tile_span(0, by)[0] for by in range(plan.grid[1])]
    cols = [plan.tile_span(bx, 0)[1] for bx in range(plan.grid[0])]
    assert _partition(rows, m) and _partition(cols, n)
    assert all(len(r) for r in rows) and all(len(c) for c in cols)
    assert plan.tile_of(plan.grid[0] - 1) == (plan.grid[0] - 1, 0)  # column tiles fastest


@pytest.mark.parametrize("label, m, n, k", PRODUCTS, ids=IDS)
def test_plan_walks_every_k_slab_once_in_order(label, m, n, k):
    """K is not split: every CTA walks all of K in slabs of 128 values in
    order, the last one short where K is not a multiple of 128 (stage 0's
    fc1, K = 192: a slab and a half, the tail zero-filled)."""
    slabs = _plan(m, n, k).k_slabs()
    assert [k0 for k0, _ in slabs] == list(range(0, k, lp.INT8_SLAB))
    assert sum(length for _, length in slabs) == k
    assert all(length == lp.INT8_SLAB for _, length in slabs[:-1])
    assert slabs[-1][1] == (k % lp.INT8_SLAB or lp.INT8_SLAB)
    assert all(length % 16 == 0 for _, length in slabs)  # whole 16-byte chunks


def test_stage0_shapes_are_ragged_as_expected():
    """Stage 0's fc1 has K = 192 (one full slab and a half one) and its fc2
    N = 192, which the 64-column form covers in three tiles and the
    128-column form in two, the second half empty."""
    assert _plan(73728, 768, 192).k_slabs() == [(0, 128), (128, 64)]
    assert _plan(73728, 192, 768, form=1).grid == (3, 576)
    wide = _plan(73728, 192, 768, form=0)
    assert wide.grid == (2, 576) and wide.tile_span(1, 0)[1] == range(128, 192)


@pytest.mark.parametrize("f", range(len(lp.INT8_FORMS)))
def test_forms_fit_shared_memory(f):
    """Every form's shared memory fits a CTA (232,448 bytes) and, at its CTAs
    an SM, the SM (233,472, 1 KB of it reserved for each CTA); two
    warpgroups over 128 rows, a width wgmma's s8 forms of hopper.cuh take;
    the finished tile, staged in the ring in fp32 (the widest output), fits
    the ring."""
    form = lp.INT8_FORMS[f]
    assert form.shared_bytes <= lp.CTA_SHARED
    assert form.ctas * (form.shared_bytes + 1024) <= lp.SM_SHARED
    assert form.bm in (64, 128) and form.bn in (64, 128) and form.stages >= 2
    assert form.bm * (form.bn * 4 + 16) <= form.stages * (form.bm + form.bn) * lp.INT8_SLAB


@pytest.mark.parametrize("label, m, n, k", PRODUCTS, ids=IDS)
def test_plan_fills_one_wave_where_the_shapes_allow(label, m, n, k):
    """At least one tile an SM wherever some form's tiles give the card that
    many."""
    plan = _plan(m, n, k)
    most = max(-(-m // f.bm) * -(-n // f.bn) for f in lp.INT8_FORMS)
    assert plan.ctas >= H100_SMS or most < H100_SMS


@pytest.mark.parametrize("sms", [132, 114, 66, 16])
def test_plan_follows_the_cards_sm_count(sms):
    """The wave comes from the card's SM count: b1 stage 2's fc2 (60 CTAs in
    the narrowest form) and fc1 fill what the card has, each output tile
    still covered once."""
    for n, k in ((768, 3072), (3072, 768)):
        plan = _plan(576, n, k, sms=sms)
        most = max(-(-576 // f.bm) * -(-n // f.bn) for f in lp.INT8_FORMS)
        assert plan.ctas >= min(sms, most)
        assert plan.grid == (-(-n // plan.tile[1]), -(-576 // plan.tile[0]))


@pytest.mark.parametrize("m, n, k, match", [
    (576, 776, 768, "multiples of 16"),   # N % 16
    (576, 768, 776, "multiples of 16"),   # K % 16
    (576, 8, 768, "unsupported shapes"),  # N < 16
    (576, 768, 8, "unsupported shapes"),  # K < 16
    (0, 768, 768, "unsupported shapes"),  # no rows
])
def test_plan_raises_outside_the_kernels_shapes(m, n, k, match):
    with pytest.raises(ValueError, match=match):
        _plan(m, n, k)
    with pytest.raises(ValueError, match=match):
        lp.mlp_a8_plan(m, k, n, H100_SMS)


def test_plan_raises_on_unknown_forms():
    with pytest.raises(ValueError, match="no form"):
        _plan(576, 768, 768, form=len(lp.INT8_FORMS))


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("stage", range(3))
def test_mlp_plan_pairs_the_two_products(b, stage):
    """fc1 is (rows, 4C) over K = C; fc2 (rows, C) over K = 4C."""
    c, res = STAGES[stage]
    m = b * res * res
    plan = lp.mlp_a8_plan(m, c, 4 * c, H100_SMS)
    assert (plan.fc1.m, plan.fc1.n, plan.fc1.k) == (m, 4 * c, c)
    assert (plan.fc2.m, plan.fc2.n, plan.fc2.k) == (m, c, 4 * c)
    assert plan.fc1 == _plan(m, 4 * c, c) and plan.fc2 == _plan(m, c, 4 * c)


# the fastest form of each main-path product on an H100 (`cli/product_forms
# --int8`, PERF.md §6): (rows, C) -> (fc1's, fc2's); b1's fc1 ran
# 0.0128 ms in 128 x 64 against 0.0134 in the 64 x 64 form the model picks
MEASURED_FASTEST = {(73728, 192): (1, 1), (18432, 384): (1, 0), (4608, 768): (0, 0),
                    (576, 768): (2, 2)}


@pytest.mark.parametrize("rows, c", sorted(MEASURED_FASTEST))
def test_plan_picks_the_measured_fastest_forms(rows, c):
    """The model's constants pick the form measured fastest at b8 stages 0-2
    and b1's fc2, and at b1's fc1 one within 5% of it."""
    plan = lp.mlp_a8_plan(rows, c, 4 * c, H100_SMS)
    assert (plan.fc1.form, plan.fc2.form) == MEASURED_FASTEST[(rows, c)]


def test_forms_mirror_the_kernels_table():
    """INT8_FORMS is `kInt8Forms` of csrc/swin_mlp_half_a8.cu, row for row,
    with its shared-memory formula `int8_smem` and its slab `kInt8Slab` (all
    read from the source)."""
    src = SOURCE.read_text()
    table = src[src.index("kInt8Forms[] = {"):]
    table = table[:table.index("};")]
    rows = re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\},\s*// (\d+)", table)
    assert [tuple(int(v) for v in r[:4]) for r in rows] == [
        (f.bm, f.bn, f.stages, f.ctas) for f in lp.INT8_FORMS]
    assert [int(r[4]) for r in rows] == list(range(len(lp.INT8_FORMS)))
    assert re.search(r"constexpr int kInt8Slab = (\d+);", src).group(1) == str(lp.INT8_SLAB)
    smem = src[src.index("constexpr int int8_smem("):]
    smem = smem[:smem.index("}")]
    expr = " ".join(smem[smem.index("return") + len("return"):smem.index(";")].split())
    for f in lp.INT8_FORMS:
        got = eval(expr.replace("f.", "F_"), {}, {  # noqa: S307 - our own source
            "F_bm": f.bm, "F_bn": f.bn, "F_stages": f.stages})
        assert got == f.shared_bytes


def test_launcher_passes_the_plans_forms():
    """The C entry point takes fc1's form and fc2's in that order, and the
    wrapper passes them from `mlp_a8_plan`."""
    src = SOURCE.read_text()
    entry = src[src.index('extern "C" int swin_mlp_half_a8_launch('):]
    assert re.search(r"int form1,\s+int form2, int dtype,", entry[:entry.index("{")])
    wrapper = pathlib.Path(sbf.__file__).read_text()
    assert "plan.fc1.form, plan.fc2.form," in wrapper


def _half_operands(rows, c, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, c), generator=g)
    norm2 = (torch.randn(c, generator=g) * 0.2 + 1.0, torch.randn(c, generator=g) * 0.2)
    lins = []
    for n, k in ((4 * c, c), (c, 4 * c)):
        w_q = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        s = (torch.rand(n, generator=g) + 0.5) * (k ** -0.5 / 73.0)
        lins.append((w_q, s, torch.randn(n, generator=g) * 0.2))
    return x, norm2, lins[0], lins[1]


@pytest.mark.parametrize("rows, c", [(24, 32), (40, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_products_alone_compose_to_the_half(rows, c, dtype):
    """The plain version of B13's products alone (`mlp_a8_product` on CPU
    tensors): fc1 gives GELU(y) and its row absmaxes, which quantize to the
    half's int8 hidden, and fc2 on that hidden with the residual gives the
    half's output, bit for bit, in fp32 and bf16."""
    x, norm2, fc1, fc2 = _half_operands(rows, c, seed=rows + c)
    x = x.to(dtype)
    out, hq, yq = sbf.swin_mlp_half_a8_reference(x, norm2, fc1, fc2, 1e-5, hidden=True)
    h = sbf.layernorm_reference(x, norm2[0], norm2[1], 1e-5).float()
    hs = qm.row_scales(h)
    y, hmax = sbf.mlp_a8_product(hq, hs[:, 0], fc1)
    assert y.dtype == torch.float32 and torch.equal(hmax, y.abs().amax(dim=1))
    assert torch.equal(qm.quantize(y, qm.row_scales(y)), yq)
    assert torch.equal(qm.row_scales(y), sbf._amax_scales(hmax))
    got = sbf.mlp_a8_product(yq, hmax, fc2, resid=x)
    assert got.dtype == dtype and torch.equal(got, out)
    assert sbf.mlp_a8_product_launches == 0  # plain-version calls do not count
