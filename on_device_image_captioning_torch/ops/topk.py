"""Vocab-wide top-k for the beam-search candidate stage (kernel K3,
`csrc/topk.cu`) and its plain version.

Replaces `on_device_image_captioning_tpu/ops/topk.py::topk_pallas`, whose
kernel takes rows of width V >= 1024 with k <= 8; so does K3, and on a CUDA
tensor of any other shape the wrapper raises. Narrow rows (the beam-pool and
final rankings of `decode/beam_search.py`) call `topk_reference` directly; its
NaN rule is one stable sort on the device, with no sync with the host.
`torch.topk` promises no order among ties, so it is neither the kernel nor
the reference.

Bound and design: see the header of `csrc/topk.cu` (one read of the row by a
cluster of CTAs, each thread's top pairs in registers, merged in a fixed
tree). `topk_plan` sizes the cluster from the shapes and the card's SM count;
`topk_owners` states the kernel's split of a row, and
`topk_chunked_reference` runs its algorithm in plain tensor code for the CPU
tests.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .linear_plan import sm_count

launches = 0  # kernel launches since the last reset (plain-version calls do not count)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MIN_KERNEL_WIDTH = 1024
MAX_KERNEL_K = 8
# csrc/topk.cu: threads a CTA, and the cluster sizes it takes (kMaxCluster
# 16; above 8 a non-portable size). The plan stops at 8: on an H100, 16 CTAs
# a row were within 4% of 8 at the decode's 5 rows and slower at 8 rows
# (`chip_smoke.py` phase 6 times every size)
THREADS = 128
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_CLUSTER = 8


def topk_reference(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, V) -> (vals (R, k) in x.dtype, idx (R, k) int32), sorted
    descending, ties to the lowest index, with the kernel's rule for a row
    holding NaN: while an unchosen NaN remains, each pick is the lowest
    unchosen index with value NaN; after the last NaN index is picked, the
    rest follow the (value desc, index asc) order. That rule is one stable
    sort once every position up to the row's last NaN is NaN (a stable
    descending sort puts NaN first, in index order), so it runs on the
    device without a sync with the host."""
    pos = torch.arange(x.shape[-1], device=x.device)
    span = torch.where(torch.isnan(x), pos, -1).amax(dim=-1, keepdim=True) + 1
    x = torch.where(pos < span, torch.nan, x)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k].clone(), idx[:, :k].to(torch.int32)


def _head(address: int, itemsize: int) -> int:
    """Values before the first 16-byte boundary at or after `address`."""
    return (-address % 16) // itemsize


def topk_owners(V: int, itemsize: int, head: int, cluster: int,
                threads: int = THREADS) -> torch.Tensor:
    """(V,) int64: the thread (rank x threads + thread) of K3's cluster that
    reads each value of a row whose first 16-byte boundary is `head` values
    in. CTA r scans the r-th contiguous share of the row's whole 16-byte
    vectors, its threads strided over the share (vector j of the share to
    thread j % threads); the head and the tail past the last whole vector go
    to rank 0's threads 0, 1, ... a value each."""
    vec = 16 // itemsize
    nvec = (V - head) // vec
    tail0 = head + nvec * vec
    per = -(-nvec // cluster)
    j = torch.arange(nvec)
    rank = j // per
    owner = torch.empty(V, dtype=torch.long)
    owner[:head] = torch.arange(head)
    owner[head:tail0] = (rank * threads + (j - rank * per) % threads).repeat_interleave(vec)
    owner[tail0:] = torch.arange(V - tail0)
    return owner


_NONE = torch.iinfo(torch.int64).max  # the index of an empty slot: after every real pair


def _best(v: torch.Tensor, i: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first n pairs of each last-axis list in the (value desc, index
    asc) order: sorted by index, then stably by value."""
    order = torch.argsort(i, dim=-1, stable=True)
    v, i = v.gather(-1, order), i.gather(-1, order)
    order = torch.argsort(v, dim=-1, descending=True, stable=True)
    return v.gather(-1, order)[..., :n], i.gather(-1, order)[..., :n]


def topk_chunked_reference(x: torch.Tensor, k: int, chunks: int,
                           lanes: int = THREADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's algorithm in plain tensor code, for the CPU tests: each row split
    as the kernel splits it over `chunks` CTAs of `lanes` threads
    (`topk_owners`, from the row's own address), each thread's sorted list
    of its top kp (k rounded up to a power of two) non-NaN pairs and its
    largest NaN index, the lists merged in the kernel's tree (a warp's 32
    lanes, the CTA's warps, the cluster's CTAs), then the NaN rule.
    Nothing on the main path calls it."""
    rows, V = x.shape
    kp = 1 << (k - 1).bit_length()
    warps = -(-lanes // 32)
    slots = chunks * warps * 32  # (rank, warp, lane): threads past `lanes` stay empty
    pos = torch.arange(V)
    vals = torch.empty((rows, k), dtype=x.dtype)
    idx = torch.empty((rows, k), dtype=torch.int32)
    for r in range(rows):
        row = x[r].float()
        owner = topk_owners(V, x.element_size(),
                            _head(x[r].data_ptr(), x.element_size()), chunks, lanes)
        slot = owner // lanes * warps * 32 + owner % lanes
        nan = torch.isnan(row)
        nan_last = int(pos[nan].max()) if bool(nan.any()) else -1
        # each thread's sorted list of its top kp non-NaN pairs: the pairs by
        # thread, then (value desc, index asc) within a thread, the first kp kept
        v, i, t = row[~nan], pos[~nan], slot[~nan]
        order = torch.argsort(v, descending=True, stable=True)  # i ascends: ties by index
        v, i, t = v[order], i[order], t[order]
        order = torch.argsort(t, stable=True)
        v, i, t = v[order], i[order], t[order]
        rank = torch.arange(t.numel()) - torch.searchsorted(t, t)
        top = rank < kp
        lv = torch.full((slots, kp), -float("inf"))
        li = torch.full((slots, kp), _NONE, dtype=torch.long)
        lv[t[top], rank[top]], li[t[top], rank[top]] = v[top], i[top]
        # merged: the warp's 32 lanes, the CTA's warps, the cluster's CTAs
        lv, li = _best(lv.reshape(chunks, warps, 32 * kp), li.reshape(chunks, warps, 32 * kp), kp)
        lv, li = _best(lv.reshape(chunks, warps * kp), li.reshape(chunks, warps * kp), kp)
        lv, li = _best(lv.reshape(chunks * kp), li.reshape(chunks * kp), kp)
        n_nan = min(k, nan_last + 1)
        past = li > nan_last
        vals[r] = torch.cat([torch.full((n_nan,), float("nan")), lv[past][: k - n_nan]]).to(x.dtype)
        idx[r] = torch.cat([torch.arange(n_nan), li[past][: k - n_nan]]).to(torch.int32)
    return vals, idx


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    cluster: int  # CTAs a row (a thread-block cluster)
    ctas: int  # CTAs of the grid: rows x cluster


@functools.lru_cache(maxsize=1024)
def topk_plan(rows: int, V: int, k: int, sms: int, itemsize: int = 4) -> TopkPlan:
    """K3's launch for `rows` rows of width V in an `itemsize`-byte type on a
    card of `sms` SMs: the smallest power-of-two cluster that brings rows x
    cluster to a wave of `sms` CTAs, at most MAX_CLUSTER and at most as many
    CTAs as leave each thread at least one 16-byte vector of the row."""
    if not 1 <= k <= MAX_KERNEL_K or V < MIN_KERNEL_WIDTH or rows < 1 or sms < 1:
        raise ValueError(f"topk: no kernel launch for rows={rows} V={V} k={k}")
    if itemsize not in (2, 4):
        raise ValueError(f"topk: unsupported item size {itemsize}")
    by_work = max(1, V * itemsize // 16 // THREADS)
    cluster = 1
    while (cluster < MAX_CLUSTER and rows * cluster < sms
           and 2 * cluster <= by_work):
        cluster *= 2
    return TopkPlan(cluster, rows * cluster)


@functools.cache
def _launcher():
    return _build.cuda_function("topk", "topk_launch", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ))


def _topk_cuda(x: torch.Tensor, k: int, cluster: Optional[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on a CUDA x (R, V): the CUDA kernel of `odic::topk`, in clusters of
    `cluster` CTAs a row (None: `topk_plan`'s)."""
    global launches
    if x.dim() != 2 or x.shape[1] < MIN_KERNEL_WIDTH or not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"topk: unsupported shape {tuple(x.shape)} / k={k}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"topk: unsupported dtype {x.dtype}")
    _build.check_cuda_tensors(x)
    rows, v = x.shape
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows == 0:
        return vals, idx
    if cluster is None:
        cluster = topk_plan(rows, v, k, sm_count(x.device), x.element_size()).cluster
    status = _launcher()(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, v, k,
                         cluster, _DTYPE_CODE[x.dtype], _build.current_stream())
    _build.check_status(status, "topk")
    launches += 1
    return vals, idx


def _topk_fake(x, k, cluster):
    return x.new_empty((x.shape[0], k)), x.new_empty((x.shape[0], k), dtype=torch.int32)


_op = _build.define_op(
    "topk", "(Tensor x, int k, int? cluster) -> (Tensor, Tensor)",
    lambda x, k, cluster: topk_reference(x, k), _topk_cuda, _topk_fake)


def launch(x: torch.Tensor, k: int, plan: TopkPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """`odic::topk` in the given plan on a CUDA x (R, V) (`topk` passes
    `topk_plan`'s; timing scripts and the card tests pass others)."""
    return _op(x, k, plan.cluster)


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis of x (R, V): `odic::topk`, the plain version
    on CPU tensors, K3 on CUDA tensors (which takes V >= 1024 and k <= 8
    only)."""
    return _op(x, k, None)
