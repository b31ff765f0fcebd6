"""The launch plan of the whole-block kernel B6 and its training twin B9a
(`ops/block_plan.py::block_plan`, which the wrappers hand to
`csrc/swin_block.cu`) on the CPU: a pure function of the shapes and the
card's SM count, so these run without a card."""
import pathlib
import re

import pytest

from on_device_image_captioning_torch.ops import block_plan as bp

H100_SMS = 132
# Swin-L/384 stages 0 and 1: (C, heads, windows an image)
STAGES = [(192, 6, 64), (384, 12, 16)]
BATCHES = [1, 2, 4, 8, 32]  # latency, the kernel table's B = 2, the XE step, serve, evaluation
SHAPES = [(b, stage) for b in BATCHES for stage in (0, 1)]
IDS = [f"b{b}-stage{stage}" for b, stage in SHAPES]
SOURCE = (pathlib.Path(bp.__file__).resolve().parents[1] / "csrc" / "swin_block.cu").read_text()


def _plan(b, stage, itemsize=2, sms=H100_SMS, hidden=None):
    c, heads, per_image = STAGES[stage]
    return bp.block_plan(b * per_image, c, heads, hidden or 4 * c, itemsize, sms)


def _partition(spans, size):
    """Whether the ranges, in order, cover 0 .. size - 1 exactly once."""
    at = 0
    for r in spans:
        if r.start != at or len(r) == 0:
            return False
        at = r.stop
    return at == size


@pytest.mark.parametrize("b, stage", SHAPES, ids=IDS)
@pytest.mark.parametrize("sms", [132, 114, 66])
def test_plan_owns_every_head_column_and_hidden_slice_once(b, stage, sms):
    """The ranks' heads, their channels (proj's and the output's columns) and
    their hidden slices (fc1's columns, fc2's rows) each partition the block,
    in rank order; every q, k and v column of Wqkv belongs to one rank."""
    plan = _plan(b, stage, sms=sms)
    c, heads, _ = STAGES[stage]
    cs = plan.cluster
    assert _partition([range(plan.head0[r], plan.head0[r] + plan.nheads[r]) for r in range(cs)],
                      heads)
    assert _partition([plan.channels(r) for r in range(cs)], c)
    assert _partition([plan.hidden_slice(r) for r in range(cs)], 4 * c)
    owners = {}
    for r in range(cs):
        for which in range(3):  # q, k, v blocks of Wqkv
            for col in plan.channels(r):
                owners.setdefault(which * c + col, []).append(r)
    assert sorted(owners) == list(range(3 * c)) and all(len(v) == 1 for v in owners.values())
    assert all(1 <= n <= 2 for n in plan.nheads)
    assert all(n % bp.HEAD == 0 for n in plan.nhid)


@pytest.mark.parametrize("b, stage", SHAPES, ids=IDS)
def test_plan_reduces_partial_sums_in_one_fixed_order(b, stage):
    """fc2's K is split over the cluster and its partial sums meet as a
    reduce-scatter: in every round each rank forms one rank's channels (the
    round is a permutation), over the rounds every rank forms every rank's
    channels once, and each owner adds them in one fixed order, its own first
    (the kernel's receive loop, read from its source: rounds in order, no
    atomics)."""
    plan = _plan(b, stage)
    cs = plan.cluster
    rounds = plan.fc2_rounds()
    assert len(rounds) == cs
    assert all(sorted(r) == list(range(cs)) for r in rounds)
    pairs = {(r, rounds[t][r]) for t in range(cs) for r in range(cs)}
    assert len(pairs) == cs * cs
    for owner in range(cs):
        order = plan.reduction_order(owner)
        assert order[0] == owner and sorted(order) == list(range(cs))
        assert [rounds[t][order[t]] for t in range(cs)] == [owner] * cs
    assert "const int o = (rank + t) % p.cluster;" in SOURCE
    assert "for (int t = 0; t < p.cluster; ++t) {" in SOURCE
    assert "atomicAdd" not in SOURCE and "red.shared" not in SOURCE


@pytest.mark.parametrize("b, stage", SHAPES, ids=IDS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_fits_shared_memory(b, stage, itemsize):
    """A CTA's shared memory is at most 227 KB (232,448 bytes): the bf16 form's
    A operand, union region and ring (2 to 8 stages, as many as fit), with
    fc2's partial-sum buffers inside the A operand's bytes; the fp32 form's
    first-port layout."""
    plan = _plan(b, stage, itemsize)
    c = STAGES[stage][0]
    assert plan.shared_bytes <= bp.CTA_SHARED == 232448
    if itemsize == 4:
        assert plan.shared_bytes == bp.f32_smem(c)
        return
    assert plan.shared_bytes == bp.block_smem(c, plan.union_bytes, plan.stages)
    assert 2 <= plan.stages <= bp.MAX_STAGES
    assert plan.stages == bp.MAX_STAGES or bp.block_smem(
        c, plan.union_bytes, plan.stages + 1) > bp.CTA_SHARED
    assert plan.union_bytes == max(max(plan.nheads) * bp.HEAD_BYTES,
                                   -(-max(plan.nhid) // 64) * bp.KBLOCK)
    assert plan.buffers * plan.recv_bytes <= bp.TOKENS * c * 2
    assert plan.buffers == 2 or 2 * plan.recv_bytes > bp.TOKENS * c * 2


@pytest.mark.parametrize("b, stage", SHAPES, ids=IDS)
@pytest.mark.parametrize("sms", [132, 114, 66, 16])
def test_plan_cluster_is_portable(b, stage, sms):
    """At most 8 CTAs a cluster (the portable size: no non-portable
    attribute), one window a cluster, the grid whole clusters."""
    plan = _plan(b, stage, sms=sms)
    assert 1 <= plan.cluster <= bp.MAX_CLUSTER == 8
    assert plan.windows == 1
    assert plan.ctas == b * STAGES[stage][2] * plan.cluster


def test_plan_runs_b1_stage1_in_one_wave():
    """b1 stage 1 has 16 windows. A 132-SM H100 holds 17 clusters of 6 CTAs
    but 15 of 8 (CLUSTER_SLOTS, from cudaOccupancyMaxActiveClusters): the
    plan gives each window 6 CTAs, so that all 16 clusters (96 CTAs) run at
    once; 8 a window would need a second wave for the 16th cluster."""
    plan = _plan(1, 1)
    assert plan.cluster == 6 and plan.ctas == 96
    assert plan.bw <= bp.cluster_slots(plan.cluster, H100_SMS)
    assert 16 > bp.cluster_slots(8, H100_SMS)


def test_cluster_slots_fit_the_card():
    """The measured slots of a 132-SM H100: clusters of k CTAs never hold more
    than 132 SMs, and every size the plan may pick has a slot."""
    assert sorted(bp.CLUSTER_SLOTS) == list(range(1, bp.MAX_CLUSTER + 1))
    assert all(k * n <= H100_SMS for k, n in bp.CLUSTER_SLOTS.items())
    assert bp.cluster_slots(4, 66) == 16 and bp.cluster_slots(8, 7) == 1


@pytest.mark.parametrize("b, stage", SHAPES, ids=IDS)
def test_plan_fills_the_slots_where_the_shapes_allow(b, stage):
    """Every main-path shape has at least as many clusters as the card runs
    at once, or all its windows in one wave."""
    plan = _plan(b, stage)
    slots = bp.cluster_slots(plan.cluster, H100_SMS)
    assert plan.bw >= slots or -(-plan.bw // slots) == 1


@pytest.mark.parametrize("sms", [132, 114, 66, 16])
def test_plan_follows_the_cards_sm_count(sms):
    """The cluster size comes from the shapes and the card's SM count alone
    (sms // k slots off the H100): the same inputs give the same plan."""
    plan = _plan(1, 1, sms=sms)
    assert plan == bp.block_plan(16, 384, 12, 1536, 2, sms)
    assert plan.cluster in (6, 7, 8)


@pytest.mark.parametrize("c, heads, hidden, itemsize, match", [
    (768, 24, 3072, 2, "built for C"),      # stage 2 runs the halves
    (192, 3, 768, 2, "built for C"),        # heads of 64
    (192, 6, 800, 2, "multiple of 96"),     # hidden
    (384, 12, 0, 4, "multiple of 96"),
    (192, 6, 768, 8, "item size"),
])
def test_plan_raises_outside_the_kernels_shapes(c, heads, hidden, itemsize, match):
    with pytest.raises(ValueError, match=match):
        bp.block_plan(16, c, heads, hidden, itemsize, H100_SMS)


def test_plan_raises_on_an_empty_grid():
    with pytest.raises(ValueError, match="unsupported shapes"):
        bp.block_plan(0, 192, 6, 768, 2, H100_SMS)


@pytest.mark.parametrize("hidden", [96 * 5, 96 * 9, 96 * 20])
def test_plan_deals_out_other_hidden_widths(hidden):
    """A hidden width that is a multiple of 96 but not of 64 still splits into
    32-column blocks owned once."""
    plan = bp.block_plan(64, 192, 6, hidden, 2, H100_SMS)
    assert _partition([plan.hidden_slice(r) for r in range(plan.cluster)], hidden)
    assert all(n % 32 == 0 for n in plan.nhid)


@pytest.mark.parametrize("b", [1, 8])
def test_main_path_choices(b):
    """The model's picks at the main path's shapes are the sizes measured
    fastest on the H100 (PERF.md): 3 CTAs a window at stage 0, 6 at stage 1."""
    assert (_plan(b, 0).cluster, _plan(b, 1).cluster) == (3, 6)


def _constexpr(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, name
    return m.group(1).split("//")[0].strip()


def test_constants_mirror_the_kernels_source():
    """block_plan's constants, its shared-memory formula and the plan's field
    order are the kernel's (read from csrc/swin_block.cu)."""
    env = {}
    for name in ("kN", "kDK", "kMaxCluster", "kMaxShared", "kThreadsH", "kBK", "kSlabCols",
                 "kStageBytes", "kMaxStages", "kKBlock", "kHeadBytes", "kRealThreads",
                 "kRecvBytesPerChannel", "kMaxPasses", "kMiscBytes", "kR", "kTiles"):
        env[name] = eval(_constexpr(name), {}, dict(env))  # noqa: S307 - our own source
    assert (env["kN"], env["kDK"], env["kMaxCluster"], env["kMaxShared"]) == (
        bp.TOKENS, bp.HEAD, bp.MAX_CLUSTER, bp.CTA_SHARED)
    assert (env["kThreadsH"], env["kBK"], env["kSlabCols"], env["kStageBytes"]) == (
        bp.THREADS, bp.SLAB_K, bp.SLAB_COLS, bp.STAGE_BYTES)
    assert (env["kMaxStages"], env["kHeadBytes"], env["kRealThreads"],
            env["kRecvBytesPerChannel"], env["kMaxPasses"], env["kMiscBytes"], env["kKBlock"]) == (
        bp.MAX_STAGES, bp.HEAD_BYTES, bp.REAL_THREADS, bp.RECV_BYTES_PER_CHANNEL, bp.MAX_PASSES,
        bp.MISC_BYTES, bp.KBLOCK)
    assert (env["kTiles"], env["kR"]) == (bp.F32_CLUSTER, bp.F32_ROWS)
    smem = SOURCE[SOURCE.index("constexpr int block_smem("):]
    expr = " ".join(smem[smem.index("return") + len("return"):smem.index(";")].split())
    for c, u, stages in ((192, 73728, 8), (384, 55296, 7), (384, 73728, 5)):
        assert eval(expr, {}, dict(env, c=c, u_bytes=u, stages=stages)) == bp.block_smem(  # noqa: S307
            c, u, stages)
    enum = SOURCE[SOURCE.index("enum PlanField {"):]
    enum = enum[:enum.index("};")]
    names = re.findall(r"kPlan(\w+)", enum)
    assert [n.lower() for n in names] == [
        "cluster", "windows", "stages", "buffers", "union", "shared", "ranks"]
    assert len(bp.PLAN_FIELDS) == names.index("Ranks")
    plan = _plan(1, 1)
    ints = plan.as_ints()
    assert len(ints) == len(bp.PLAN_FIELDS) + 4 * bp.MAX_CLUSTER
    assert ints[:len(bp.PLAN_FIELDS)] == tuple(getattr(plan, f) for f in (
        "cluster", "windows", "stages", "buffers", "union_bytes", "shared_bytes"))


def test_fp32_plan_is_the_first_ports_rows_form():
    plan = _plan(2, 1, itemsize=4)
    assert (plan.cluster, plan.windows, plan.shared_bytes) == (3, 1, bp.f32_smem(384))
    assert plan.nheads == (0, 0, 0)  # the rows form: no rank owns columns
    assert (bp.f32_smem(192), bp.f32_smem(384)) == (128512, 175360)
