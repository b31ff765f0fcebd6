"""The launch plan of the whole-block kernel B6 and its training twin B9a
(`csrc/swin_block.cu`): how a window's work is split over the CTAs of a
thread-block cluster, decided on the host from the shapes and the card's SM
count, and handed to the C launcher, which only checks it.

In bf16 a cluster of `cluster` CTAs holds one window and splits its work by
COLUMNS, so that every weight byte crosses L2 -> SM once per window: rank r
owns heads head0[r] .. head0[r] + nheads[r] (their q, k, v columns, their
attention and the same channels of proj and of the block's output) and the
hidden slice hid0[r] .. hid0[r] + nhid[r] (fc1's columns, fc2's rows). fc2's
K is therefore split, and its partial sums meet as a reduce-scatter over
`cluster` rounds: in round t rank r forms the partial product of rank
(r + t) % cluster's channels over its own slice and stores it into that
rank's shared memory; each rank adds what it receives in round order, its
own partial first, then those of ranks r - 1, r - 2, ... (mod cluster): a
fixed order, so two launches agree bit for bit. A rank holds one or two
heads; the first `heads % cluster` ranks hold one head more than the others,
the hidden width is dealt out in 32-column blocks the same way.

Shared memory (`block_smem` in the kernel's source, mirrored here): the
window's 144 rows of the resident A operand (LN1(x'), then the attention
output, then x1 and LN2(x1), then fc2's receive buffers: two where they fit,
else one and a second barrier a round), a union region (the own heads'
q | k | v, then the hidden slice), and a ring of W slabs with as many stages
as fit (at most 8).

How the cluster size is chosen: among those the kernel takes (1 or 2 heads a
rank, the bytes within a CTA's 227 KB), the least modelled time: the waves of
clusters the card runs at once times the busiest rank's share of a window's
operations plus a fixed cost a CTA pays whatever its share (LN1 of the whole
window, two gathers of whole rows, the attention's score loads, the cluster
barriers), CTA_OVERHEAD of a window's operations. How many clusters of k
CTAs (one CTA an SM) the card runs at once is not sms // k: a cluster lives
in one GPC. For a 132-SM H100 the plan reads CLUSTER_SLOTS, what
`cudaOccupancyMaxActiveClusters` reported there (PERF.md); for another SM
count, sms // k. The fixed cost makes few CTAs a window win: two heads a CTA
(3 at C = 192, 6 at C = 384) at every main-path batch, b1 included, where 8
CTAs a window would give clusters of 8, of which the card holds 15, not 16.

In fp32 the kernel keeps the first port's CUDA-core design: three CTAs a
window, 48 query rows each (`cluster` 3, the plan's rank tables unused).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch

TOKENS = 144  # kN: tokens of a window
HEAD = 32  # kDK: head width
WIDTHS = (192, 384)  # the block widths B6 is built for (Swin-L stages 0 and 1)
MAX_CLUSTER = 8  # kMaxCluster: the portable cluster size
THREADS = 384  # kThreadsH: three consumer warpgroups
SLAB_K = 32  # kBK: K rows of a W slab
SLAB_COLS = 128  # kSlabCols: the widest product pass
STAGE_BYTES = SLAB_K * SLAB_COLS * 2  # kStageBytes
MAX_STAGES = 8  # kMaxStages
HEAD_BYTES = 3 * TOKENS * 64  # kHeadBytes: q, k, v of one head
REAL_THREADS = 288  # kRealThreads: threads whose accumulator rows include real rows
RECV_BYTES_PER_CHANNEL = 2 * REAL_THREADS  # kRecvBytesPerChannel: fc2 partial sums a channel
MISC_BYTES = 2048  # kMiscBytes
KBLOCK = TOKENS * 128  # kKBlock: a 64-wide K block of a resident A operand
MAX_PASSES = 24  # kMaxPasses: product passes of a CTA
CTA_SHARED = 232448  # kMaxShared: shared memory a CTA may hold on the H100 (227 KB)
# clusters of k CTAs (one an SM) a 132-SM H100 runs at once, as
# cudaOccupancyMaxActiveClusters reports it on an NVIDIA H100 80GB HBM3
# (`card_cluster_slots`; `cli/block_forms.py` prints it, a card test holds it)
H100_SMS = 132
CLUSTER_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# the fixed cost of a CTA, as a fraction of a window's operations: fitted by
# `cli/block_forms.py` to B6's times at 3 and 6 CTAs a window at the kernel
# table's shape on an NVIDIA H100 80GB HBM3 (PERF.md); any value from 0.1 up
# gives the same picks at the main path's shapes
CTA_OVERHEAD = 0.22
# fp32: the first port's form (kTiles CTAs of kR query rows a window)
F32_CLUSTER, F32_ROWS = 3, 48

# the plan's fields as the C launcher reads them (PlanField), then four tables
# of MAX_CLUSTER ranks: head0, nheads, hid0, nhid
PLAN_FIELDS = ("cluster", "windows", "stages", "buffers", "union_bytes", "shared_bytes")


def block_smem(c: int, u_bytes: int, stages: int) -> int:
    """`block_smem` of the kernel's source: 1024 to align, the resident A
    operand (144 x c bf16), the union region, the ring, the barriers and the
    window's source rows."""
    return 1024 + TOKENS * c * 2 + u_bytes + stages * STAGE_BYTES + MISC_BYTES


def f32_smem(c: int) -> int:
    """`smem_f32<NT>` of the kernel's source (the fp32 form, NT = c / 96)."""
    lda = c + 4
    att = F32_ROWS * lda * 4
    slab, scores = F32_ROWS * (96 + 4) * 4, F32_ROWS * (TOKENS + 1) * 4
    phase1 = TOKENS * 97 * 4 + max(slab, scores)
    phase2 = att + F32_ROWS * (96 + 4) * 4
    return 1024 + 16 * 96 * 4 + att + max(phase1, phase2)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _deal(total: int, parts: int) -> List[int]:
    """total units over parts, the first total % parts one more."""
    base, extra = divmod(total, parts)
    return [base + (r < extra) for r in range(parts)]


def _starts(sizes: List[int]) -> List[int]:
    out, at = [], 0
    for s in sizes:
        out.append(at)
        at += s
    return out


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    bw: int
    c: int
    heads: int
    hidden: int
    itemsize: int
    cluster: int  # CTAs a window
    windows: int  # windows a cluster
    head0: Tuple[int, ...]
    nheads: Tuple[int, ...]
    hid0: Tuple[int, ...]
    nhid: Tuple[int, ...]
    stages: int  # W slabs the ring holds
    buffers: int  # fc2 rounds' partial-sum buffers (2 lets a round start before the last is read)
    union_bytes: int
    shared_bytes: int

    @property
    def ctas(self) -> int:
        return self.bw // self.windows * self.cluster

    def channels(self, rank: int) -> range:
        """The block's channels rank owns (its heads' q, k, v, attention, proj
        and output columns)."""
        return range(HEAD * self.head0[rank], HEAD * (self.head0[rank] + self.nheads[rank]))

    def hidden_slice(self, rank: int) -> range:
        return range(self.hid0[rank], self.hid0[rank] + self.nhid[rank])

    def fc2_rounds(self) -> List[Tuple[int, ...]]:
        """fc2's reduce-scatter: for each round t, the rank whose channels
        rank r forms the partial product of (r + t) % cluster, by r."""
        return [tuple((r + t) % self.cluster for r in range(self.cluster))
                for t in range(self.cluster)]

    def reduction_order(self, owner: int) -> Tuple[int, ...]:
        """The ranks whose partial sums of owner's channels are added, in the
        order they are added: round t brings rank (owner - t)'s."""
        return tuple((owner - t) % self.cluster for t in range(self.cluster))

    @property
    def recv_bytes(self) -> int:
        """One round's partial sums of the widest owner (a receive buffer)."""
        return max(self.nheads) * HEAD * RECV_BYTES_PER_CHANNEL

    def as_ints(self) -> Tuple[int, ...]:
        """The plan as the C launcher reads it (PlanField, then the rank
        tables padded to MAX_CLUSTER)."""
        pad = lambda t: tuple(t) + (0,) * (MAX_CLUSTER - len(t))  # noqa: E731
        return (self.cluster, self.windows, self.stages, self.buffers, self.union_bytes,
                self.shared_bytes) + pad(self.head0) + pad(self.nheads) + pad(self.hid0) + pad(
                    self.nhid)


def _columns_plan(bw: int, c: int, heads: int, hidden: int, cs: int):
    """The bf16 plan of cluster size cs, or None where the kernel does not
    take it."""
    nheads = _deal(heads, cs)
    if min(nheads) < 1 or max(nheads) > 2:
        return None
    head0 = _starts(nheads)
    nhid = [HEAD * u for u in _deal(hidden // HEAD, cs)]
    if min(nhid) < HEAD:
        return None
    union = max(max(nheads) * HEAD_BYTES, _cdiv(max(nhid), 64) * KBLOCK)
    if max(nheads) + 1 + _cdiv(max(nhid), SLAB_COLS) + cs > MAX_PASSES:
        return None
    stages = min(MAX_STAGES, (CTA_SHARED - block_smem(c, union, 0)) // STAGE_BYTES)
    if stages < 2:
        return None
    buffers = 2 if 2 * max(nheads) * HEAD * RECV_BYTES_PER_CHANNEL <= TOKENS * c * 2 else 1
    return BlockPlan(bw, c, heads, hidden, 2, cs, 1, tuple(head0), tuple(nheads),
                     tuple(_starts(nhid)), tuple(nhid), stages, buffers, union,
                     block_smem(c, union, stages))


def _window_ops(c: int, hidden: int) -> Tuple[int, int, int]:
    """Operations of a window a channel, a head's worth, and a hidden column:
    qkv, attention and proj per channel; fc1 and fc2 per hidden column."""
    per_channel = TOKENS * (2 * c * 3 + 4 * TOKENS + 2 * c)
    per_hidden = TOKENS * 4 * c
    return per_channel, per_hidden, per_channel * c + per_hidden * hidden


def busiest_share(plan: BlockPlan) -> float:
    """The largest share of a window's operations one rank of the plan does."""
    per_channel, per_hidden, window = _window_ops(plan.c, plan.hidden)
    return max(HEAD * n * per_channel + h * per_hidden
               for n, h in zip(plan.nheads, plan.nhid)) / window


def modelled_time(plan: BlockPlan, sms: int) -> float:
    """The model's time of a plan, in windows' operations (module head)."""
    return _cdiv(plan.bw, cluster_slots(plan.cluster, sms)) * (busiest_share(plan) + CTA_OVERHEAD)


def cluster_slots(cluster: int, sms: int) -> int:
    """Clusters of `cluster` CTAs (one an SM) the card runs at once."""
    if sms == H100_SMS:
        return CLUSTER_SLOTS[cluster]
    return max(1, sms // cluster)


@functools.lru_cache(maxsize=1024)
def block_plan(bw: int, c: int, heads: int, hidden: int, itemsize: int, sms: int) -> BlockPlan:
    """The launch of B6 / B9a on bw windows of 144 tokens at width c, on a
    card of `sms` SMs. Raises ValueError where the kernel does not take the
    shapes: heads of 32, c in (192, 384), hidden a positive multiple of 96."""
    if itemsize not in (2, 4):
        raise ValueError(f"block_plan: unsupported item size {itemsize}")
    if c not in WIDTHS or c != heads * HEAD:
        raise ValueError(f"block_plan: built for C in {WIDTHS} with heads of {HEAD}, got "
                         f"C={c}, {heads} heads")
    if hidden <= 0 or hidden % 96:
        raise ValueError(f"block_plan: hidden {hidden} is not a multiple of 96")
    if bw < 1 or sms < 1:
        raise ValueError(f"block_plan: unsupported shapes bw={bw} sms={sms}")
    if itemsize == 4:
        z = (0,) * F32_CLUSTER
        return BlockPlan(bw, c, heads, hidden, 4, F32_CLUSTER, 1, z, z, z, z, 0, 0, 0, f32_smem(c))
    plans = [p for cs in range(1, MAX_CLUSTER + 1)
             if (p := _columns_plan(bw, c, heads, hidden, cs)) is not None]
    if not plans:
        raise ValueError(f"block_plan: no cluster takes C={c}, hidden {hidden}")
    return min(plans, key=lambda p: (modelled_time(p, sms), p.cluster))


def card_cluster_slots(c: int, cluster: int, shared_bytes: int) -> int:
    """Clusters of `cluster` B6 CTAs (width c, `shared_bytes` each) the
    current card runs at once (`cudaOccupancyMaxActiveClusters`, through
    `csrc/swin_block.cu`): what CLUSTER_SLOTS records for the H100."""
    from . import _build

    fn = _build.cuda_function("swin_block", "swin_block_max_clusters",
                              [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check_status(fn(c, cluster, shared_bytes, ctypes.byref(out)), "swin_block_max_clusters")
    return out.value


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_for(x: torch.Tensor, heads: int, hidden: int) -> BlockPlan:
    """The plan a wrapper launches for window-partitioned x (bw, 144, c)."""
    return block_plan(x.shape[0], x.shape[2], heads, hidden, x.element_size(),
                      _sm_count(x.device))
