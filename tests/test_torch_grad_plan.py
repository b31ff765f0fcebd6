"""The launch plan of the training backwards' product
(`ops/linear_plan.py::grad_plan`, which the wrappers of B9b and B9c hand to
`csrc/fused_linear.cuh`) and of B9b's attention core (`core_chunk`) on the
CPU: pure functions of the shapes and the card's SM count, so these run
without a card."""
import pathlib
import re

import pytest

from on_device_image_captioning_torch.ops import linear_plan as lp
from on_device_image_captioning_torch.ops import swin_block_fused as sbf

H100_SMS = 132
CSRC = pathlib.Path(lp.__file__).resolve().parents[1] / "csrc"
# Swin-L/384 stages 0-2: (C, heads, token-grid side)
STAGES = [(192, 6, 96), (384, 12, 48), (768, 24, 24)]
BATCHES = [2, 4]  # the kernel cases' B = 2 (ops/_cases.py) and the XE step's b4


def _products():
    """(label, M, N, K, layout) of every product of B9c and B9b at each stage
    and batch: B9c's fc1 recompute, dh1, dxn2, dW1, dW2; B9b's dao, dxn1,
    dWproj, dWqkv."""
    out = []
    for b in BATCHES:
        for stage, (c, _, res) in enumerate(STAGES):
            r = b * res * res
            for name, m, n, k, layout in (
                    ("fc1", r, 4 * c, c, "xw"), ("dh1", r, 4 * c, c, "dywt"),
                    ("dxn2", r, c, 4 * c, "dywt"), ("dW1", c, 4 * c, r, "atb"),
                    ("dW2", 4 * c, c, r, "atb"), ("dao", r, c, c, "dywt"),
                    ("dxn1", r, c, 3 * c, "dywt"), ("dWproj", c, c, r, "atb"),
                    ("dWqkv", c, 3 * c, r, "atb")):
                out.append((f"b{b} stage{stage} {name}", m, n, k, layout))
    return out


PRODUCTS = _products()
IDS = [p[0] for p in PRODUCTS]


def _plan(m, n, k, layout, itemsize=2, sms=H100_SMS):
    return lp.grad_plan(m, n, k, layout, itemsize, sms)


def _partition(spans, size):
    """Whether the ranges, in the order given, cover 0 .. size - 1 exactly
    once, each starting where the one before it ended."""
    flat = [i for r in spans for i in r]
    return flat == list(range(size)) and all(len(r) for r in spans)


@pytest.mark.parametrize("label, m, n, k, layout", PRODUCTS, ids=IDS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_grad_plan_has_a_form_whose_slab_divides_k(label, m, n, k, layout, itemsize):
    """Every backward product of the XE step gets a tile form (bf16: one the
    layout takes) whose slab divides K, and a split count: chunks of whole
    slabs, K itself for the row products, which never split."""
    plan = _plan(m, n, k, layout, itemsize)
    assert k % plan.slab == 0
    assert plan.splits >= 1 and plan.k_chunk % plan.slab == 0
    if itemsize == 2:
        f = lp.GRAD_FORMS[plan.form]
        assert (f.bm, f.bn, f.bk) == (*plan.tile, plan.slab)
        assert layout == "dywt" or f.bn % 64 == 0  # an MN-major B in whole 64-column blocks
    else:
        assert plan.form == -1 and plan.tile == lp.FP32_TILE and plan.slab == lp.FP32_SLAB
    if layout != "atb":
        assert plan.splits == 1 and plan.k_chunk == k


@pytest.mark.parametrize("label, m, n, k, layout", PRODUCTS, ids=IDS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_grad_plan_chunks_cover_every_row_once_in_order(label, m, n, k, layout, itemsize):
    """The split's chunks, in the order their partials are summed, cover
    0 .. K - 1 once, each chunk at least GRAD_MIN_SLABS slabs but the last;
    the grid has one blockIdx.z per chunk."""
    plan = _plan(m, n, k, layout, itemsize)
    chunks = plan.k_chunks()
    assert _partition(chunks, k) and len(chunks) == plan.grid[2]
    assert all(len(r) == plan.k_chunk for r in chunks[:-1])
    if plan.splits > 1:
        assert plan.k_chunk >= lp.GRAD_MIN_SLABS * plan.slab


@pytest.mark.parametrize("label, m, n, k, layout", PRODUCTS, ids=IDS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_grad_plan_covers_every_output_tile_once(label, m, n, k, layout, itemsize):
    plan = _plan(m, n, k, layout, itemsize)
    bm, bn = plan.tile
    rows = [range(y * bm, min(m, (y + 1) * bm)) for y in range(plan.grid[1])]
    cols = [range(x * bn, min(n, (x + 1) * bn)) for x in range(plan.grid[0])]
    assert _partition(rows, m) and _partition(cols, n)


@pytest.mark.parametrize("label, m, n, k, layout", [p for p in PRODUCTS if p[4] == "atb"],
                         ids=[p[0] for p in PRODUCTS if p[4] == "atb"])
def test_grad_plan_fills_the_card_on_the_weight_gradients(label, m, n, k, layout):
    """A weight gradient has few output tiles and many rows: the split gives
    the card a CTA for most of its slots (at 2 CTAs an SM), unless the rows
    run out of whole chunks first."""
    plan = _plan(m, n, k, layout)
    f = lp.GRAD_FORMS[plan.form]
    tiles = plan.grid[0] * plan.grid[1]
    slots = H100_SMS * f.ctas
    assert plan.ctas <= max(slots, tiles) + tiles  # one wave, give or take a chunk's tiles
    assert plan.ctas >= min(slots // 2, tiles * (k // plan.slab // lp.GRAD_MIN_SLABS))


def test_grad_forms_fit_shared_memory():
    """Each form's shared memory fits a CTA (232,448 bytes) and, at its CTAs
    an SM, the SM (233,472, 1 KB of it reserved for each CTA)."""
    for f in lp.GRAD_FORMS:
        assert lp.grad_shared_bytes(f) <= lp.CTA_SHARED
        assert f.ctas * (lp.grad_shared_bytes(f) + 1024) <= lp.SM_SHARED


def test_grad_forms_mirror_the_kernels_table():
    """GRAD_FORMS is `kGradForms` of csrc/fused_linear.cuh, row for row, with
    its shared-memory formula `grad_smem`, and GRAD_LAYOUTS its GradLayout
    enum (both read from the source)."""
    src = (CSRC / "fused_linear.cuh").read_text()
    table = src[src.index("kGradForms[] = {"):]
    table = table[:table.index("};")]
    rows = re.findall(r"\{(\d+), (\d+), (\d+), (\d+), (\d+)\},\s*// (\d+)", table)
    assert [tuple(int(v) for v in r[:5]) for r in rows] == [
        (f.bm, f.bn, f.bk, f.stages, f.ctas) for f in lp.GRAD_FORMS]
    assert [int(r[5]) for r in rows] == list(range(len(lp.GRAD_FORMS)))
    smem = src[src.index("constexpr int grad_smem("):]
    smem = smem[:smem.index("}")]
    expr = " ".join(smem[smem.index("return") + len("return"):smem.index(";")].split())
    for f in lp.GRAD_FORMS:
        got = eval(expr.replace("f.", "F_"), {}, {  # noqa: S307 - our own source
            "F_bm": f.bm, "F_bn": f.bn, "F_bk": f.bk, "F_stages": f.stages})
        assert got == lp.grad_shared_bytes(f)
    enum = re.search(r"enum GradLayout \{([^}]*)\}", src).group(1)
    assert [e.split("=")[0].strip() for e in enum.split(",")] == ["kXW", "kDYWT", "kATB"]
    assert lp.GRAD_LAYOUTS == ("xw", "dywt", "atb")


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_core_chunk_covers_every_window_once(b, stage):
    """B9b's core walks the windows in chunks of core_chunk, a CTA a (chunk,
    head): every window once, in order, and no more CTAs than the card runs
    in the waves the plan counted."""
    c, heads, res = STAGES[stage]
    bw = b * (res // 12) ** 2
    g = lp.core_chunk(bw, heads, 144, H100_SMS)
    chunks = [range(z * g, min(bw, (z + 1) * g)) for z in range(-(-bw // g))]
    assert _partition(chunks, bw) and 1 <= g <= bw


@pytest.mark.parametrize("sms", [132, 114, 66, 16])
def test_core_chunk_follows_the_cards_sm_count(sms):
    """Fewer SMs take longer chunks, never shorter ones than a larger card."""
    assert lp.core_chunk(256, 6, 144, sms) >= lp.core_chunk(256, 6, 144, 132) or sms == 132


def _enum_len(path: str, name: str) -> int:
    src = (CSRC / path).read_text()
    body = re.search(r"enum " + name + r" \{([^}]*)\}", src).group(1)
    names = [e.strip() for e in body.split(",") if e.strip()]
    return names.index(names[-1])


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_backward_launch_plans_match_the_launchers(b, stage, itemsize):
    """The plans the wrappers pass: as many ints as the launchers' plan enums
    name, and partials of the counts the launchers sum (row passes of
    kRowPassRows rows a CTA; db1 by dh1's row tiles; dbias and dbqkv by the
    core's chunks; the weight gradients by the split's chunks)."""
    c, heads, res = STAGES[stage]
    bw = b * (res // 12) ** 2
    rows = bw * 144
    rows_src = (CSRC / "backward_rows.cuh").read_text()
    assert f"constexpr int kRowPassRows = {sbf.ROW_PASS_ROWS};" in rows_src
    parts = -(-rows // sbf.ROW_PASS_ROWS)

    ints, shapes = sbf._mlp_bwd_plan(rows, c, 4 * c, itemsize, H100_SMS)
    assert len(ints) == _enum_len("swin_mlp_bwd.cu", "MlpPlan")
    dh1 = lp.grad_plan(rows, 4 * c, c, "dywt", itemsize, H100_SMS)
    dw2 = lp.grad_plan(4 * c, c, rows, "atb", itemsize, H100_SMS)
    dw1 = lp.grad_plan(c, 4 * c, rows, "atb", itemsize, H100_SMS)
    assert list(ints) == [lp.grad_plan(rows, c, 4 * c, "dywt", itemsize, H100_SMS).form,
                          dw2.form, dw2.k_chunk, dw1.form, dw1.k_chunk]
    hidden_tiles = (-(-rows // sbf.HIDDEN_TILE_ROWS) if itemsize == 2
                    else dh1.grid[1])
    assert shapes == ((dw1.splits, c, 4 * c), (dw2.splits, 4 * c, c), (hidden_tiles, 4 * c),
                      (parts, c), (parts, c), (parts, c))

    ints, shapes = sbf._attn_bwd_plan(bw, 144, c, heads, itemsize, H100_SMS)
    assert len(ints) == _enum_len("swin_attn_bwd.cu", "AttnPlan")
    chunk = lp.core_chunk(bw, heads, 144, H100_SMS)
    assert ints[-1] == chunk
    chunks = -(-bw // chunk)
    assert shapes[2] == (chunks, 3 * c) and shapes[6] == (chunks, heads, 144, 144)
    assert shapes[3:6] == ((parts, c),) * 3


@pytest.mark.parametrize("m, n, k, layout", [(577, 768, 192, "xw"), (1153, 200, 576, "dywt"),
                                             (200, 584, 1160, "atb"), (8, 8, 8, "atb"),
                                             (1, 8, 8, "dywt"), (36864, 768, 192, "xw")])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_grad_plan_takes_ragged_shapes(m, n, k, layout, itemsize):
    """Shapes off the main path that the product takes (M >= 1, N and K
    multiples of 8, M too for "atb"): partial last tiles and a partial last
    chunk, every output tile and K value still covered once."""
    plan = _plan(m, n, k, layout, itemsize)
    assert plan.grid[:2] == (-(-n // plan.tile[1]), -(-m // plan.tile[0]))
    assert _partition(plan.k_chunks(), k)


@pytest.mark.parametrize("m, n, k, layout, match", [
    (576, 772, 768, "xw", "multiples of 8"),
    (576, 768, 772, "dywt", "multiples of 8"),
    (190, 768, 576, "atb", "multiples of 8"),
    (0, 768, 768, "xw", "unsupported shapes"),
    (576, 768, 768, "ab", "unknown layout"),
])
def test_grad_plan_raises_outside_the_kernels_shapes(m, n, k, layout, match):
    for itemsize in (2, 4):
        with pytest.raises(ValueError, match=match):
            _plan(m, n, k, layout, itemsize)


def test_hidden_tile_rows_mirror_the_kernel():
    """B9c's fused hidden-row product (bf16) runs in `kHiddenForm` of
    csrc/swin_mlp_bwd.cu: its row tiles are the db1 partials' rows the
    wrapper allocates, and it fits two CTAs an SM."""
    src = (CSRC / "swin_mlp_bwd.cu").read_text()
    bm, bn, bk, stages, ctas = (int(v) for v in re.search(
        r"constexpr GradForm kHiddenForm = \{(\d+), (\d+), (\d+), (\d+), (\d+)\};", src).groups())
    assert bm == sbf.HIDDEN_TILE_ROWS
    f = lp.Form(bm, bn, bk, stages, ctas)
    smem = lp.grad_shared_bytes(f) + 2 * stages * 8 + bn * 4  # barriers, bias
    assert ctas * (smem + 1024) <= lp.SM_SHARED
