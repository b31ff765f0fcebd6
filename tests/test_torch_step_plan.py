"""The decode-step kernels' launch plan (`ops/dyn_exp_step.py::step_plan`,
which the wrappers hand to `csrc/dyn_exp_step.cu`'s launchers) and the
wrappers' checks of their operands, on the CPU: a pure function of the shapes
and the card's SM count, so these run without a card."""
import pytest
import torch

from on_device_image_captioning_torch.ops import dyn_exp_step as k2

E, D, HEADS, S = 16, 512, 8, 144
H100_SMS = 132
# (rows, L): b1 x beam 5 at L74 (latency), b8 x beam 3 at L20 (serve), b8 x
# beam 5, one row, b8 x beam 3 at L74, and b4 x beam 3 (one scorer cluster
# and one chunk of every position)
SHAPES = [(5, 74), (24, 20), (40, 20), (1, 74), (1, 20), (24, 74), (40, 74), (5, 20),
          (12, 20), (12, 74)]


def _plan(rows, L, itemsize, heads, d=D, sms=H100_SMS):
    return k2.step_plan(rows, L, E, d, itemsize, heads, S if heads else 0, sms=sms)


@pytest.mark.parametrize("rows, L", SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads", [0, HEADS])
def test_step_plan_covers_every_position_once(rows, L, itemsize, heads):
    """The clusters of a row partition its L positions: one cluster takes
    them all, or the scorers take none (they form the forward scores and the
    new vals rows, each for its share of the E rows of q_i, which they
    partition) and every other a chunk that is not empty; the grid holds the
    row's clusters side by side."""
    plan = _plan(rows, L, itemsize, heads)
    seen = [p for c in range(plan.chunks) for p in plan.chunk_positions(c, L)]
    assert seen == list(range(L))
    if plan.chunks > 1:
        assert all(len(plan.chunk_positions(c, L)) == 0 for c in range(plan.scorers))
        assert all(len(plan.chunk_positions(c, L)) > 0
                   for c in range(plan.scorers, plan.chunks))
    rows_of_q = [e for c in range(plan.chunks) for e in plan.scorer_rows(c, E)]
    assert rows_of_q == list(range(E))
    assert plan.grid == (plan.cluster * plan.chunks, rows)
    assert plan.ctas <= k2.CTAS_PER_SM * H100_SMS or plan.chunks == 1


@pytest.mark.parametrize("rows, L", [(5, 74), (12, 20), (1, 74), (2, 20)])
def test_step_plan_fills_one_wave_of_the_card(rows, L):
    """The plan takes its wave from the card's SM count: at most CTAS_PER_SM
    x sms CTAs (one cluster a row at the least), fewer clusters a row on a
    smaller card, every position still covered once."""
    chunks = []
    for sms in (132, 114, 66, 16):
        plan = _plan(rows, L, 2, 0, sms=sms)
        assert plan.ctas <= k2.CTAS_PER_SM * sms or plan.chunks == 1
        seen = [p for c in range(plan.chunks) for p in plan.chunk_positions(c, L)]
        assert seen == list(range(L))
        chunks.append(plan.chunks)
    assert chunks == sorted(chunks, reverse=True)
    assert chunks[-1] < chunks[0]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads", [0, HEADS])
def test_step_plan_covers_the_card_at_the_latency_shape(itemsize, heads):
    """At b1 x beam 5 and L74 the grid holds at least one CTA per SM of an
    H100 (132)."""
    assert _plan(5, 74, itemsize, heads).ctas >= 132


@pytest.mark.parametrize("rows, L", SHAPES)
def test_step_plan_fits_the_card(rows, L):
    """Clusters of at most 8 CTAs (the portable size: no non-portable
    attribute is set); shared memory within the 227 KB a CTA may hold, the
    largest case (fp32, L74, with the tail) included."""
    for itemsize in (2, 4):
        for heads in (0, HEADS):
            plan = _plan(rows, L, itemsize, heads)
            assert plan.cluster <= 8
            assert plan.shared_bytes <= 227 * 1024
            assert 4 * sum(plan.regions) < plan.shared_bytes
    assert _plan(rows, 74, 4, HEADS).shared_bytes <= 227 * 1024


@pytest.mark.parametrize("d, itemsize, heads, match", [
    (520, 2, 0, "column slices"),     # not 8 slices of whole 16-byte chunks
    (96, 4, 0, "column slices"),      # 24 chunks a row: no divisor of 256 threads
    (4096, 2, 0, "column slices"),    # 512 chunks a row: more than the threads
    (1024, 2, 0, "column slices"),    # wider than a lane's registers hold
    (D, 2, 4, "heads"),               # fewer heads than the cluster's CTAs
    (D, 2, 12, "heads"),              # heads not a multiple of the cluster
    (D, 8, 0, "item size"),
])
def test_step_plan_raises_outside_the_kernels_shapes(d, itemsize, heads, match):
    with pytest.raises(ValueError, match=match):
        _plan(5, 74, itemsize, heads, d=d)


def _step_operands(b=3, L=6, e=4, d=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    src = [torch.randn((b, L, d), generator=g).to(dtype) for _ in range(4)]
    src += [torch.randn((b, L, e, d), generator=g).to(dtype) for _ in range(2)]
    rows = [torch.randn((b, e, d), generator=g).to(dtype) for _ in range(2)]
    rows += [torch.randn((b, d), generator=g).to(dtype) for _ in range(4)]
    sel = torch.rand((b, d), generator=g)
    embed = torch.randn((e, d), generator=g).to(dtype)
    reorder = torch.tensor([1, 1, 0], dtype=torch.int32)
    return reorder, rows, sel, embed, src


def _check(reorder, rows, sel, embed, src, dst, pos=2):
    return k2._check_step_operands("dyn_exp_step", pos, reorder, *rows, sel, embed, src, dst)


def test_check_step_operands_accepts_distinct_caches():
    reorder, rows, sel, embed, src = _step_operands()
    dst = [torch.empty_like(t) for t in src]
    assert _check(reorder, rows, sel, embed, src, dst) == (3, 6, 4, 64)


@pytest.mark.parametrize("which", [0, 4])
def test_check_step_operands_raises_on_overlapping_views(which):
    """The kernels read src through `__restrict__` pointers while they write
    dst: a dst cache that is a view into a src cache's bytes, though it starts
    elsewhere, is refused (start pointers alone would let it through)."""
    reorder, rows, sel, embed, src = _step_operands()
    dst = [torch.empty_like(t) for t in src]
    shape = src[which].shape
    big = torch.empty(2 * src[which].numel(), dtype=src[which].dtype)
    src[which] = big[: src[which].numel()].view(shape)
    dst[which] = big[src[which].numel() // 2:][: src[which].numel()].view(shape)
    assert src[which].data_ptr() != dst[which].data_ptr()
    with pytest.raises(ValueError, match="alias"):
        _check(reorder, rows, sel, embed, src, dst)


def test_byte_ranges_overlap():
    """`bytes_overlap` finds a shared byte between the two sides, whatever
    their order in memory, and none between tensors that only touch, between
    tensors of one side, or with an empty tensor."""
    buf = torch.zeros(64, dtype=torch.bfloat16)
    other = torch.zeros(64, dtype=torch.bfloat16)
    ov = k2.bytes_overlap
    assert ov([buf[:32]], [buf[31:]])
    assert ov([buf[31:]], [buf[:32]])
    assert not ov([buf[:32]], [buf[32:]])
    assert ov([buf], [buf[10:12]])
    assert ov([other, buf[40:]], [buf[:8], buf[20:41]])
    assert not ov([buf[:0]], [buf])
    assert not ov([buf], [other])
    assert not ov([buf[:16], buf[8:24]], [buf[24:], other])
