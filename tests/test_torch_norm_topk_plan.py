"""The launch plans of K4 (`ops/layernorm.py::layernorm_plan`) and K3
(`ops/topk.py::topk_plan`, `topk_owners`) on the CPU: pure functions of the
shapes and the card's SM count, held to the constants of their C sources.
Also K3's algorithm in plain tensor code (`topk_chunked_reference`: each
thread's list of its top pairs, the merge tree, the NaN rule) held exactly to
`topk_reference` over many splits of a row, and the two wrappers' routing."""
import pathlib
import re

import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.ops import layernorm as k4
from on_device_image_captioning_torch.ops import topk as k3

H100_SMS = 132
CSRC = pathlib.Path(k4.__file__).resolve().parents[1] / "csrc"
LN_SOURCE = (CSRC / "layernorm.cu").read_text()
TOPK_SOURCE = (CSRC / "topk.cu").read_text()


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


# ---------------------------------------------------------------------------
# K4: the plan
# ---------------------------------------------------------------------------

def test_layernorm_plan_constants_match_the_source():
    assert _constant(LN_SOURCE, "kThreads") == k4.THREADS
    assert _constant(LN_SOURCE, "kCtasPerSm") == k4.CTAS_PER_SM
    cases = [int(n) for n in re.findall(r"case (\d+): return launch_chunks<T, \1>", LN_SOURCE)]
    assert tuple(cases) == k4.LANE_CHUNKS
    assert "case 0:" in LN_SOURCE  # the any-width kernel


# (rows, C, dtype): the main path's calls (decode, encoder, both backbones at
# b8 and B = 2) and widths off it
MAIN_NORMS = [
    (24, 512, torch.float32), (5, 512, torch.float32), (1152, 512, torch.bfloat16),
    (1152, 1536, torch.bfloat16), (73728, 192, torch.bfloat16), (18432, 192, torch.bfloat16),
    (18432, 192, torch.float32), (4608, 384, torch.bfloat16), (4608, 384, torch.float32),
    (1152, 768, torch.bfloat16), (288, 1536, torch.float32), (288, 3072, torch.bfloat16),
    (288, 3072, torch.float32), (288, 512, torch.float32),
]
OTHER_NORMS = [(77, 33, torch.float32), (77, 64, torch.bfloat16), (77, 130, torch.float32),
               (3, 40, torch.float32), (9, 8, torch.bfloat16), (1, 4000, torch.float32),
               (300, 96, torch.float32)]


@pytest.mark.parametrize("rows, c, dtype", MAIN_NORMS + OTHER_NORMS,
                         ids=[f"{r}x{c}-{str(d)[6:]}" for r, c, d in MAIN_NORMS + OTHER_NORMS])
@pytest.mark.parametrize("sms", [H100_SMS, 78])
def test_layernorm_plan_covers_every_row_once(rows, c, dtype, sms):
    """The grid's warps, numbered CTA first and walking with a grid-wide
    stride, take every row exactly once; at most CTAS_PER_SM CTAs an SM, and
    no CTA without a row."""
    plan = k4.layernorm_plan(rows, c, dtype, sms)
    assert 1 <= plan.ctas <= k4.CTAS_PER_SM * sms
    warps = k4.THREADS // 32
    seen = np.concatenate([np.asarray(plan.rows_of(cta, w, rows), dtype=np.int64)
                           for cta in range(plan.ctas) for w in range(warps)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(rows))
    assert all(plan.rows_of(cta, 0, rows) for cta in range(plan.ctas))


@pytest.mark.parametrize("rows, c, dtype", MAIN_NORMS,
                         ids=[f"{r}x{c}-{str(d)[6:]}" for r, c, d in MAIN_NORMS])
def test_layernorm_plan_fits_main_path_rows_exactly(rows, c, dtype):
    """Every main-path width splits into whole 16-byte chunks over a lane
    group with no idle lane: C = 192 bf16 is 8 lanes of 3 chunks (four rows
    a warp), fp32 16 lanes of 3; the decode's C = 512 fp32 32 lanes of 4."""
    plan = k4.layernorm_plan(rows, c, dtype, H100_SMS)
    chunks = c * dtype.itemsize // 16
    assert plan.lane_chunks in k4.LANE_CHUNKS
    assert plan.group * plan.lane_chunks == chunks
    assert 32 % plan.group == 0
    expect = {(192, torch.bfloat16): (8, 3), (192, torch.float32): (16, 3),
              (512, torch.float32): (32, 4)}
    if (c, dtype) in expect:
        assert (plan.group, plan.lane_chunks) == expect[(c, dtype)]


@pytest.mark.parametrize("c, dtype, aligned, want", [
    (33, torch.float32, True, 0), (130, torch.float32, True, 0), (33, torch.bfloat16, True, 0),
    (64, torch.float32, True, 1), (64, torch.float32, False, 0), (192, torch.bfloat16, False, 0),
    (40, torch.float32, True, 1), (4000, torch.float32, True, 0), (1000, torch.float32, True, 8),
])
def test_layernorm_plan_picks_the_instance(c, dtype, aligned, want):
    """Rows of no whole 16-byte chunks, unaligned operands or more than 32 x
    24 chunks take the any-width kernel (0); the rest the fewest chunks a
    lane that hold the row (a ragged 32-lane form where no group fits)."""
    plan = k4.layernorm_plan(100, c, dtype, H100_SMS, aligned)
    assert plan.lane_chunks == want
    if want:
        chunks = c * dtype.itemsize // 16
        assert plan.group * plan.lane_chunks >= chunks
        assert plan.group * (plan.lane_chunks - 1) < chunks or plan.group < 32
    else:
        assert plan.group == 32


@pytest.mark.parametrize("args", [(0, 192, torch.float32, 132), (8, 0, torch.float32, 132),
                                  (8, 192, torch.float16, 132), (8, 192, torch.float32, 0)])
def test_layernorm_plan_refuses(args):
    with pytest.raises(ValueError):
        k4.layernorm_plan(*args)


# ---------------------------------------------------------------------------
# K3: the plan and the split of a row
# ---------------------------------------------------------------------------

def test_topk_plan_constants_match_the_source():
    assert _constant(TOPK_SOURCE, "kThreads") == k3.THREADS
    assert _constant(TOPK_SOURCE, "kMaxCluster") == max(k3.CLUSTER_SIZES)
    assert _constant(TOPK_SOURCE, "kMaxK") == k3.MAX_KERNEL_K
    assert k3.MAX_CLUSTER in k3.CLUSTER_SIZES
    lists = sorted({int(n) for n in re.findall(r"launch_typed<T, (\d+)>", TOPK_SOURCE)})
    assert lists == [1, 2, 4, 8]  # k rounded up to a power of two


TOPK_SHAPES = [(1, 10000), (5, 10000), (8, 10000), (24, 10000), (40, 10000), (132, 10000),
               (160, 10000), (24, 1024), (3, 1024), (24, 32000), (2, 4097)]


@pytest.mark.parametrize("rows, v", TOPK_SHAPES, ids=[f"{r}x{v}" for r, v in TOPK_SHAPES])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("sms", [H100_SMS, 78])
def test_topk_plan_reaches_a_wave_and_respects_its_limits(rows, v, itemsize, sms):
    """The cluster is a power of two within the plan's ceiling, the smallest
    that brings rows x cluster to `sms` CTAs unless the ceiling or the row's
    vectors (at least THREADS a CTA) stop it; the grid is rows x cluster."""
    plan = k3.topk_plan(rows, v, 3, sms, itemsize)
    vectors = v * itemsize // 16
    assert plan.cluster in k3.CLUSTER_SIZES and plan.cluster <= k3.MAX_CLUSTER
    assert plan.ctas == rows * plan.cluster
    if plan.cluster > 1:
        assert rows * plan.cluster // 2 < sms  # no larger than a wave needs
        assert vectors // plan.cluster >= k3.THREADS  # every thread has a vector
    grow = 2 * plan.cluster
    assert (rows * plan.cluster >= sms or plan.cluster == k3.MAX_CLUSTER
            or vectors // grow < k3.THREADS)


def test_topk_plan_main_path_clusters():
    """b8 x beam 3 and b1 x beam 5 at V = 10000 on an H100: 8 CTAs a row."""
    assert k3.topk_plan(24, 10000, 3, H100_SMS).cluster == 8
    assert k3.topk_plan(5, 10000, 5, H100_SMS).cluster == 8
    assert k3.topk_plan(24, 10000, 3, H100_SMS, 2).cluster == 8
    assert k3.topk_plan(160, 10000, 8, H100_SMS).cluster == 1


@pytest.mark.parametrize("args", [(4, 10000, 0, 132), (4, 10000, 9, 132), (4, 512, 3, 132),
                                  (0, 10000, 3, 132), (4, 10000, 3, 132, 8)])
def test_topk_plan_refuses(args):
    with pytest.raises(ValueError):
        k3.topk_plan(*args)


@pytest.mark.parametrize("v", [1024, 10000, 10001, 4099])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("cluster", k3.CLUSTER_SIZES)
def test_topk_owners_cover_every_value_once(v, itemsize, cluster):
    """Every value of a row is read by exactly one thread of the cluster,
    whatever its head: rank r's share of the whole vectors is contiguous, its
    threads strided over it; the head and the tail go to rank 0's first
    threads."""
    vec = 16 // itemsize
    for head in range(vec):
        owner = k3.topk_owners(v, itemsize, head, cluster)
        assert owner.shape == (v,)
        assert int(owner.min()) >= 0 and int(owner.max()) < cluster * k3.THREADS
        nvec = (v - head) // vec
        body = owner[head: head + nvec * vec].reshape(nvec, vec)
        assert bool((body == body[:, :1]).all())  # a vector belongs to one thread
        rank = body[:, 0] // k3.THREADS
        assert bool((rank[1:] >= rank[:-1]).all())  # contiguous shares in rank order
        counts = torch.bincount(rank, minlength=cluster)
        assert int(counts.max()) == -(-nvec // cluster)  # shares of ceil(nvec / cluster)
        tail = owner[head + nvec * vec:]
        assert torch.equal(owner[:head], torch.arange(head))
        assert torch.equal(tail, torch.arange(tail.numel()))


# ---------------------------------------------------------------------------
# K3: the chunked plain form against topk_reference
# ---------------------------------------------------------------------------

SPLITS = [(1, 128), (8, 128), (16, 128), (3, 64), (5, 96), (7, 32), (2, 8)]


def _assert_same(got, want):
    (gv, gi), (wv, wi) = got, want
    assert gi.dtype == torch.int32 and gv.dtype == wv.dtype
    assert torch.equal(gi, wi)
    assert torch.equal(gv.isnan(), wv.isnan())
    assert torch.equal(gv.float().nan_to_num(), wv.float().nan_to_num())


def _check_splits(x, k):
    want = k3.topk_reference(x, k)
    for chunks, lanes in SPLITS:
        _assert_same(k3.topk_chunked_reference(x, k, chunks, lanes), want)


@pytest.mark.parametrize("trial", range(4))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_chunked_matches_reference_on_tie_fuzz(trial, dtype):
    """Few distinct values force dense exact ties; ties go to the lowest index."""
    rng = np.random.default_rng(100 + trial)
    rows, v = int(rng.integers(2, 9)), int(rng.choice([1024, 2048, 4096, 1031]))
    levels = rng.standard_normal(4).astype(np.float32)
    x = torch.from_numpy(levels[rng.integers(0, 4, (rows, v))]).to(dtype)
    for k in (1, int(rng.integers(2, 8)), 8):
        _check_splits(x, k)


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_topk_chunked_matches_reference_on_planted_ties(k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 2048)).astype(np.float32)
    x[:, 100] = x[:, 7]
    x[:, 200] = x.max(axis=1)
    x[:, 900] = x.max(axis=1)
    x[:, 2047] = x.max(axis=1)
    _check_splits(torch.from_numpy(x), k)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_topk_chunked_matches_reference_on_inf_and_nan_rows(k):
    """Rows of fewer than k finite values (the -inf tail by ascending index),
    NaN at index 0, before k, past k and at the last index, two NaNs."""
    v = 2048
    x = np.full((9, v), -np.inf, dtype=np.float32)
    x[1, 10] = 3.0
    x[2, 5], x[2, 17] = 1.0, 2.0
    for r in range(3, 9):
        x[r] = np.linspace(1, -1, v, dtype=np.float32)
    x[3, 0] = np.nan
    x[4, 3] = np.nan
    x[5, 1500] = np.nan
    x[6, v - 1] = np.nan
    x[7, 1], x[7, 6] = np.nan, np.nan
    x[8, 2] = -np.inf
    x[8, v - 1] = np.nan
    x[8, :8] = x[8, 8]  # ties before the NaN
    _check_splits(torch.from_numpy(x), k)
    _check_splits(torch.from_numpy(x).bfloat16(), k)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_topk_chunked_matches_reference_on_unaligned_rows(offset):
    """Rows that start off a 16-byte boundary and widths of no whole vectors:
    heads and tails of every length go to rank 0's threads."""
    rng = np.random.default_rng(offset)
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.from_numpy(rng.standard_normal(5 * 1029 + 8).astype(np.float32)).to(dtype)
        x = flat[offset: offset + 5 * 1029].view(5, 1029)
        x[2, 7] = float("nan")
        x[3] = x[3].round()
        for k in (1, 4, 7):
            _check_splits(x, k)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_layernorm_and_topk_route_by_device():
    """A CPU tensor gets the plain version and launches nothing; a meta
    tensor gets the op's fake implementation (shapes and dtypes only); a
    tensor the dispatcher has no kernel for (here a sparse one) is refused by
    the dispatcher."""
    before = (k4.launches, k3.launches)
    x = torch.randn((6, 1024))
    w, b = torch.randn(1024), torch.randn(1024)
    assert torch.equal(k4.layernorm(x, w, b), k4.layernorm_reference(x, w, b))
    got, want = k3.topk(x, 3), k3.topk_reference(x, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (k4.launches, k3.launches) == before
    out = k4.layernorm(x.to("meta"), w.to("meta"), b.to("meta"))
    assert out.is_meta and out.shape == x.shape and out.dtype == x.dtype
    vals, idx = k3.topk(x.to("meta"), 3)
    assert vals.is_meta and vals.shape == (6, 3) and idx.dtype == torch.int32
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        k4.layernorm(x.to_sparse(), w, b)
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        k3.topk(x.to_sparse(), 3)
    assert (k4.launches, k3.launches) == before
