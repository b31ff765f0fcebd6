"""The launch plans of the backbone's products (`csrc/fused_linear.cuh`):
which tile each product launches in, decided on the host from the shapes and
the card's SM count, and handed to the C launchers of B4, B5, B9b and
B10a / B10b (the forward product, `linear_plan`), of B8 (the forward
product's MERGE form where it splits K, `merge_plan`), of B9b and B9c (the
backward product, `grad_plan`, and B9b's attention core, `core_chunk`) and of
B13 (the int8 product, `int8_plan`).

In bf16 the product runs on `linear_wgmma_kernel`, whose tile forms are the
table `kProductForms` of that file (mirrored here, in its order, as FORMS;
the CPU tests hold the two to each other). A form is BM rows (a warpgroup of
128 threads for every 64) by BN columns, walked over K in slabs of BK through
a ring of `stages` slabs of shared memory, at `ctas` CTAs an SM. The plan
passes the form's index. In fp32 the product runs on the CUDA cores in one
128 x 96 tile (slabs of 16) and the index is not read.

How a form is chosen. Measured on an H100 (PERF.md), the product's time
follows the bytes its SMs draw from L2: about 45 GB/s an SM that holds two
CTAs or more, about half that with one. So the model's time of a form is the
busiest SM's tiles (ceil(tiles / SMs) of them) times a tile's bytes (its A
and W slabs and its output) over that SM's rate. Among the forms whose slab
divides a gathered row (K / segs; BK 32 only where 64 does not), those with a
tile for every SM, if any has; of these the least time. `linear_plan` never
splits K: at every M of B4's and B5's main path (576 rows and up) the
smallest tile gives the card 108 CTAs or more. B8's plan (`merge_plan`,
below) does, where its few tiles leave SMs idle.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Form:
    bm: int
    bn: int
    bk: int
    stages: int
    ctas: int  # CTAs an SM holds at this shared memory (the launch bounds)

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory, as `product_smem` in the kernel's source:
        the ring, 1024 bytes to align it, a full and an empty barrier per
        stage, the gathered source rows (4 segments) and the bias of the
        tile's columns."""
        ring = self.stages * (self.bm * self.bk + self.bk * self.bn) * 2
        return ring + 1024 + 2 * self.stages * 8 + 4 * self.bm * 8 + self.bn * 4


# `kProductForms` of csrc/fused_linear.cuh, in its order
FORMS: Tuple[Form, ...] = (
    Form(128, 128, 64, 3, 2),
    Form(64, 128, 64, 4, 2),
    Form(64, 64, 64, 4, 3),
    Form(64, 64, 32, 4, 3),
)
SM_L2_BYTES = 45e9  # bytes an SM draws from L2 under load, two CTAs or more on it
FP32_TILE, FP32_SLAB = (128, 96), 16  # fused_linear_kernel<float, 8, 6>
CTA_SHARED = 232448  # shared memory a CTA may hold on the H100 (227 KB)
SM_SHARED = 233472  # an SM's (228 KB), 1 KB of it reserved for each CTA


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LinearPlan:
    m: int
    n: int
    k: int
    segs: int
    form: int  # index of FORMS; -1 for fp32 (the CUDA cores' tile)
    tile: Tuple[int, int]  # (rows, columns) of a CTA's output tile
    slab: int  # K values of a slab
    grid: Tuple[int, int]  # (column tiles, row tiles), blockIdx.x and .y

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]

    def tile_span(self, bx: int, by: int) -> Tuple[range, range]:
        """The output rows and columns CTA (bx, by) writes (clipped to M, N)."""
        bm, bn = self.tile
        return (range(by * bm, min(self.m, (by + 1) * bm)),
                range(bx * bn, min(self.n, (bx + 1) * bn)))

    def k_slabs(self) -> List[Tuple[int, int]]:
        """The (segment, offset in the gathered row) of each K slab, in the
        order every CTA walks them: all of K, once."""
        ks = self.k // self.segs
        return [(k0 // ks, k0 % ks) for k0 in range(0, self.k, self.slab)]


def _seconds(f: Form, m: int, n: int, k: int, sms: int) -> float:
    """The model's time of the product in form f (see the module's head)."""
    per_sm = _cdiv(_cdiv(m, f.bm) * _cdiv(n, f.bn), sms)
    rate = SM_L2_BYTES * min(1.0, min(f.ctas, per_sm) / 2)
    return per_sm * ((f.bm + f.bn) * k * 2 + f.bm * f.bn * 2) / rate


@functools.lru_cache(maxsize=4096)
def linear_plan(m: int, n: int, k: int, segs: int, itemsize: int, sms: int) -> LinearPlan:
    """The launch of the product out (M, N) = prologue(gather(A)) @ W (K, N),
    A gathered as `segs` rows of K / segs, on a card of `sms` SMs. Raises
    ValueError where the kernels do not take the shapes: M >= 1, N a multiple
    of 8 (16-byte rows), segs 1 to 4 and K / segs a multiple of 32 (no slab
    straddles two gathered rows)."""
    if itemsize not in (2, 4):
        raise ValueError(f"linear_plan: unsupported item size {itemsize}")
    if m < 1 or n < 8 or sms < 1 or not 1 <= segs <= 4:
        raise ValueError(f"linear_plan: unsupported shapes M={m} N={n} segs={segs}")
    if n % 8:
        raise ValueError(f"linear_plan: N={n} is not a multiple of 8")
    if k % segs or (k // segs) % 32 or k < 32:
        raise ValueError(f"linear_plan: K / segs = {k} / {segs} is not a multiple of 32")
    if itemsize == 4:
        (bm, bn), bk, form = FP32_TILE, FP32_SLAB, -1
    else:
        fits = [i for i, f in enumerate(FORMS) if (k // segs) % f.bk == 0]
        if any(FORMS[i].bk == 64 for i in fits):
            fits = [i for i in fits if FORMS[i].bk == 64]
        filling = [i for i in fits
                   if _cdiv(m, FORMS[i].bm) * _cdiv(n, FORMS[i].bn) >= sms]
        form = min(filling or fits, key=lambda i: (_seconds(FORMS[i], m, n, k, sms), i))
        f = FORMS[form]
        bm, bn, bk = f.bm, f.bn, f.bk
    return LinearPlan(m, n, k, segs, form, (bm, bn), bk, (_cdiv(n, bn), _cdiv(m, bm)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def form_for(x: torch.Tensor, m: int, n: int, k: int, segs: int = 1) -> int:
    """The form index a wrapper passes for a product on x's card and dtype."""
    return linear_plan(m, n, k, segs, x.element_size(), sm_count(x.device)).form


# ---------------------------------------------------------------------------
# The training backwards' product (B9b, B9c): `grad_wgmma_kernel` of
# csrc/fused_linear.cuh in bf16, in three operand layouts (GRAD_LAYOUTS, the
# C enum GradLayout in its order): "xw" x @ W (A K-major, B MN-major), "dywt"
# dY @ W^T (A and B K-major), "atb" X^T @ dY (A and B MN-major, K = the rows).
# Its tile forms are `kGradForms` of that file (GRAD_FORMS here, in order; the
# CPU tests hold the two to each other). A form whose BN is not a multiple of
# 64 takes no MN-major B. fp32 runs the CUDA cores' 128 x 96 tile in slabs of
# 16 (form -1).
#
# Only "atb" splits K: the rows (tens of thousands) into `splits` chunks of
# k_chunk rows, so that the few output tiles of a weight gradient (12 at
# stage 0: 192 x 768) fill the card; each chunk's CTAs write an fp32 partial,
# summed in chunk order afterwards. Among the forms the layout takes, the
# least modelled time: the busiest SM's CTAs times a CTA's bytes (its A and B
# slabs and its output) over the SM's L2 rate, whatever the CTAs an SM holds,
# a one-warpgroup form (64 x 192) at GRAD_ONE_WG_RATE of it (fitted to
# `cli/product_forms --backward` on an H100, PERF.md §6);
# the split count is as many chunks as one wave of the card's CTA slots holds
# (at least GRAD_MIN_SLABS slabs a chunk). The row products keep their whole K.

GRAD_LAYOUTS = ("xw", "dywt", "atb")
_B_MN = {"xw": True, "dywt": False, "atb": True}
# `kGradForms` of csrc/fused_linear.cuh, in its order
GRAD_FORMS: Tuple[Form, ...] = (
    Form(128, 128, 64, 3, 2),
    Form(128, 96, 64, 3, 2),
    Form(64, 192, 64, 3, 2),
)
GRAD_MIN_SLABS = 8
GRAD_ONE_WG_RATE = 0.7


def grad_shared_bytes(f: Form) -> int:
    """Dynamic shared memory of a backward form, as `grad_smem` in the
    kernel's source: the ring, 1024 bytes to align it, a full and an empty
    barrier per stage."""
    return f.stages * (f.bm * f.bk + f.bk * f.bn) * 2 + 1024 + 2 * f.stages * 8


@dataclasses.dataclass(frozen=True)
class GradPlan:
    m: int
    n: int
    k: int
    layout: str
    form: int  # index of GRAD_FORMS; -1 for fp32 (the CUDA cores' tile)
    tile: Tuple[int, int]  # (rows, columns) of a CTA's output tile
    slab: int  # K values of a slab
    k_chunk: int  # K values a chunk (blockIdx.z) walks: k itself unless split
    grid: Tuple[int, int, int]  # (column tiles, row tiles, chunks)

    @property
    def splits(self) -> int:
        return self.grid[2]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def k_chunks(self) -> List[range]:
        """The K values (rows, for "atb") of each chunk, in the order their
        partials are summed."""
        return [range(z * self.k_chunk, min(self.k, (z + 1) * self.k_chunk))
                for z in range(self.splits)]


def _grad_split(f_ctas: int, tiles: int, slabs: int, sms: int) -> int:
    """As many chunks as the card's CTA slots hold at once (every chunk's
    partial is written and read back: no more than one wave of them), at
    least GRAD_MIN_SLABS slabs each."""
    return max(1, min(sms * f_ctas // tiles, slabs // GRAD_MIN_SLABS))


def _grad_seconds(bm: int, bn: int, m: int, n: int, k_chunk: int, splits: int, out_bytes: int,
                  sms: int) -> float:
    """The model's time of a backward product: the busiest SM's CTAs times a
    CTA's bytes (its A and B slabs over its chunk, and its output tile) over
    the SM's L2 rate, which a form of one warpgroup (BM = 64) reaches only
    GRAD_ONE_WG_RATE of."""
    ctas = _cdiv(m, bm) * _cdiv(n, bn) * splits
    rate = SM_L2_BYTES * (1.0 if bm >= 128 else GRAD_ONE_WG_RATE)
    return _cdiv(ctas, sms) * ((bm + bn) * k_chunk * 2 + bm * bn * out_bytes) / rate


@functools.lru_cache(maxsize=4096)
def grad_plan(m: int, n: int, k: int, layout: str, itemsize: int, sms: int,
              form: Optional[int] = None) -> GradPlan:
    """The launch of the backward product out (M, N) = A (M, K) @ B (K, N) in
    `layout` on a card of `sms` SMs, in the form of least modelled time or
    in `form` (bf16; a yardstick's way to compare forms). Raises ValueError
    where the kernels do not take the shapes: M, N, K >= 1; N and K multiples
    of 8 (16-byte rows), and M too for "atb" (its A rows run along M)."""
    if layout not in GRAD_LAYOUTS:
        raise ValueError(f"grad_plan: unknown layout {layout!r}")
    if itemsize not in (2, 4):
        raise ValueError(f"grad_plan: unsupported item size {itemsize}")
    if m < 1 or n < 8 or k < 8 or sms < 1:
        raise ValueError(f"grad_plan: unsupported shapes M={m} N={n} K={k}")
    if n % 8 or k % 8 or (layout == "atb" and m % 8):
        raise ValueError(f"grad_plan: M={m}, N={n}, K={k} are not multiples of 8")
    split = layout == "atb"

    def chunk_of(bm, bn, bk, ctas):
        slabs = _cdiv(k, bk)
        splits = _grad_split(ctas, _cdiv(m, bm) * _cdiv(n, bn), slabs, sms) if split else 1
        return min(k, _cdiv(slabs, splits) * bk)

    if itemsize == 4:
        (bm, bn), bk, form = FP32_TILE, FP32_SLAB, -1
        k_chunk = chunk_of(bm, bn, bk, 2)
    else:
        fits = [i for i, f in enumerate(GRAD_FORMS) if not (_B_MN[layout] and f.bn % 64)]
        if form is None:
            def cost(i):
                f = GRAD_FORMS[i]
                chunk = chunk_of(f.bm, f.bn, f.bk, f.ctas)
                return _grad_seconds(f.bm, f.bn, m, n, chunk, _cdiv(k, chunk),
                                     4 if split else itemsize, sms)

            form = min(fits, key=lambda i: (cost(i), i))
        elif form not in fits:
            raise ValueError(f"grad_plan: form {form} does not take layout {layout!r}")
        f = GRAD_FORMS[form]
        bm, bn, bk = f.bm, f.bn, f.bk
        k_chunk = chunk_of(bm, bn, bk, f.ctas)
    return GradPlan(m, n, k, layout, form, (bm, bn), bk, k_chunk,
                    (_cdiv(n, bn), _cdiv(m, bm), _cdiv(k, k_chunk)))


# B9b's attention core runs one CTA per (chunk of windows, head), one CTA an
# SM (its shared memory), the chunk's windows in order (dbias and dbqkv are
# per-chunk partials, summed in chunk order). The chunk is the one whose
# waves of CTAs take the least time: waves x windows a chunk x CORE_WINDOW_S,
# plus writing and reading back the dbias partials (heads x N^2 fp32 a chunk).
CORE_WINDOW_S = 20e-6  # a (window, head) of 144 tokens on one SM
HBM_BYTES_S = 3.35e12


@functools.lru_cache(maxsize=1024)
def core_chunk(bw: int, heads: int, n: int, sms: int) -> int:
    """Windows a CTA of the attention core takes, one after another."""
    if bw < 1 or heads < 1 or n < 1 or sms < 1:
        raise ValueError(f"core_chunk: unsupported shapes bw={bw} heads={heads} n={n}")

    def cost(g):
        chunks = _cdiv(bw, g)
        waves = _cdiv(chunks * heads, sms)
        return waves * g * CORE_WINDOW_S + 2 * chunks * heads * n * n * 4 / HBM_BYTES_S

    return min(range(1, bw + 1), key=lambda g: (cost(g), -g))


# ---------------------------------------------------------------------------
# B13's int8 products (`a8_product_kernel` of csrc/swin_mlp_half_a8.cu): wgmma
# s8 x s8 -> s32 with both operands K-major, K in slabs of 128 values (one
# 128-byte swizzled row; a zero-filled tail where K is not a multiple of 128),
# a CTA of one or two warpgroups over a BM x BN tile, K never split. The tile
# forms are `kInt8Forms` of that file (INT8_FORMS here, in order; the CPU
# tests hold the two to each other). The grid is one-dimensional, a CTA a tile: CTA t
# takes row tile t // column tiles and column tile t % column tiles.
#
# How a form is chosen: the least modelled time. The grid runs in rounds of
# one tile on each CTA slot of every SM (form.ctas an SM). A round takes the
# longer of its tiles' A and W slabs through the SM's share of L2
# (INT8_SM_BYTES_S) and their epilogues on the SM's ALUs (INT8_VALUE_S an
# output value: fc1's exact-erf GELU costs as much as its products), plus a
# ring's fill (INT8_ROUND_S) and one tile's epilogue that no other CTA
# hides. The three constants are fitted to `cli/product_forms --int8` on an
# H100 (PERF.md): they pick the measured-fastest form at seven of the main
# path's eight products and one within 5% at the eighth (b1's fc1).

INT8_SLAB = 128
INT8_SM_BYTES_S = 80e9  # operand bytes an SM draws from L2 a second for the int8 products
INT8_VALUE_S = 0.2e-9  # epilogue seconds an output value on one SM
INT8_ROUND_S = 4e-6  # a round's exposed latency: the ring's first slabs
MAX_GRID = 2**31 - 1  # CTAs of a one-dimensional grid


@dataclasses.dataclass(frozen=True)
class Int8Form:
    bm: int
    bn: int
    stages: int
    ctas: int  # CTAs an SM holds at this shared memory (the launch bounds)

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory, as `int8_smem` in the kernel's source: the
        ring, 1024 bytes to align it, a full and an empty barrier per stage,
        a scale a row, a scale and a bias a column."""
        return (self.stages * (self.bm + self.bn) * INT8_SLAB + 1024 + 2 * self.stages * 8
                + (self.bm + 2 * self.bn) * 4)


# `kInt8Forms` of csrc/swin_mlp_half_a8.cu, in its order
INT8_FORMS: Tuple[Int8Form, ...] = (
    Int8Form(128, 128, 3, 2),
    Int8Form(128, 64, 3, 3),
    Int8Form(64, 64, 3, 4),
)


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    m: int
    n: int
    k: int
    form: int  # index of INT8_FORMS
    tile: Tuple[int, int]  # (rows, columns) of a CTA's output tile
    grid: Tuple[int, int]  # (column tiles, row tiles), flattened column tiles fastest

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]

    def tile_of(self, cta: int) -> Tuple[int, int]:
        """(column tile, row tile) of CTA `cta` of the one-dimensional grid."""
        return cta % self.grid[0], cta // self.grid[0]

    def tile_span(self, bx: int, by: int) -> Tuple[range, range]:
        """The output rows and columns tile (bx, by) writes (clipped to M, N)."""
        bm, bn = self.tile
        return (range(by * bm, min(self.m, (by + 1) * bm)),
                range(bx * bn, min(self.n, (bx + 1) * bn)))

    def k_slabs(self) -> List[Tuple[int, int]]:
        """(first K value, values read) of each slab, in the order every CTA
        walks them; the last slab's zero-filled tail is not read."""
        return [(k0, min(INT8_SLAB, self.k - k0)) for k0 in range(0, self.k, INT8_SLAB)]


def _int8_seconds(f: Int8Form, m: int, n: int, k: int, sms: int) -> float:
    """The model's time of an int8 product in form f (see above)."""
    rounds = _cdiv(_cdiv(m, f.bm) * _cdiv(n, f.bn), sms * f.ctas)
    loads = f.ctas * (f.bm + f.bn) * _cdiv(k, INT8_SLAB) * INT8_SLAB / INT8_SM_BYTES_S
    epilogue = f.bm * f.bn * INT8_VALUE_S
    return rounds * (max(loads, f.ctas * epilogue) + INT8_ROUND_S + epilogue)


@functools.lru_cache(maxsize=4096)
def int8_plan(m: int, n: int, k: int, sms: int, form: Optional[int] = None) -> Int8Plan:
    """The launch of B13's int8 product out (M, N) = A (M, K) @ W (N, K)^T on
    a card of `sms` SMs, in the form of least modelled time or in `form` (a
    yardstick's way to compare forms). Raises ValueError where the kernel
    does not take the shapes: M >= 1, N and K positive multiples of 16
    (16-byte int8 chunks and staged output rows)."""
    if m < 1 or n < 16 or k < 16 or sms < 1:
        raise ValueError(f"int8_plan: unsupported shapes M={m} N={n} K={k}")
    if n % 16 or k % 16:
        raise ValueError(f"int8_plan: N={n} and K={k} must be multiples of 16")
    if form is None:
        form = min(range(len(INT8_FORMS)),
                   key=lambda i: (_int8_seconds(INT8_FORMS[i], m, n, k, sms), i))
    elif not 0 <= form < len(INT8_FORMS):
        raise ValueError(f"int8_plan: no form {form}")
    f = INT8_FORMS[form]
    grid = (_cdiv(n, f.bn), _cdiv(m, f.bm))
    if grid[0] * grid[1] > MAX_GRID:
        raise ValueError(f"int8_plan: M={m} x N={n} takes more CTAs than a grid holds")
    return Int8Plan(m, n, k, form, (f.bm, f.bn), grid)


@dataclasses.dataclass(frozen=True)
class MlpA8Plan:
    fc1: Int8Plan  # (rows, hidden) fp32 GELU = LN2 rows (rows, C) @ W1 (hidden, C)^T
    fc2: Int8Plan  # (rows, C) = int8 hidden (rows, hidden) @ W2 (C, hidden)^T


@functools.lru_cache(maxsize=1024)
def mlp_a8_plan(rows: int, c: int, hidden: int, sms: int) -> MlpA8Plan:
    """B13's launch: fc1's form and fc2's."""
    return MlpA8Plan(int8_plan(rows, hidden, c, sms), int8_plan(rows, c, hidden, sms))


# ---------------------------------------------------------------------------
# B8 (`downsample_fused`), bf16, takes one of two routes. Where its few tiles
# leave CTA slots idle, the MERGE form of `linear_wgmma_kernel` (the LayerNorm
# applied to each gathered A slab in the ring from a pre-pass's row
# statistics) in a tile form of FORMS, with K split into `splits` chunks of
# whole slabs over a cluster of 2 to MAX_SPLITS CTAs along z (a portable
# cluster), the partial tiles summed in rank order in the cluster's shared
# memory. Where the tiles fill the card, the scratch route (splits = 1):
# `ln_rows_kernel` writes the normalized rows once and the plain form reads
# them (`linear_plan`'s form, K whole), as B4 and B5 run. fp32 runs the CUDA
# cores' 128 x 96 tile, K whole.
#
# How they are chosen: the least modelled time over tile forms and splits.
# CTAs (tiles x splits) run in rounds of one on every CTA slot of the card
# (form.ctas an SM); a CTA takes MERGE_CTA_S (its ring's fill and its
# epilogue) plus MERGE_VALUE_S for every A value it walks (BM rows x its
# chunk of K: the gathered loads and their normalization, which set the
# pace, not W's columns). Fitted to `cli/product_forms --merge` on an H100
# (PERF.md §6): it picks the measured-fastest form and split, or one within
# 8% of it, at every main-path shape and at B = 2. Chunks of fewer than
# MERGE_MIN_SLABS slabs are not taken (measured slower everywhere). Where the
# least time is unsplit, the tiles fill the card and the split buys nothing;
# the ring would then normalize each row again for each of its column tiles,
# which measured slower than the scratch's one pass (b8 stages 0 and 1), so
# the scratch route runs instead.

MAX_SPLITS = 8
MERGE_SPLITS = (1, 2, 3, 4, 6, 8)
MERGE_MIN_SLABS = 4
MERGE_CTA_S = 2e-6
MERGE_VALUE_S = 1e-6 / (128 * 64)  # a 64-wide slab of 128 rows: 1 us


@dataclasses.dataclass(frozen=True)
class MergePlan:
    m: int
    n: int
    k: int
    segs: int
    form: int  # index of FORMS; -1 for fp32 (the CUDA cores' tile)
    tile: Tuple[int, int]  # (rows, columns) of a CTA's output tile
    slab: int  # K values of a slab
    k_chunk: int  # K values a blockIdx.z sums (k itself unless split)
    grid: Tuple[int, int, int]  # (column tiles, row tiles, splits)

    @property
    def splits(self) -> int:
        return self.grid[2]

    @property
    def ring(self) -> bool:
        """The MERGE form (the LayerNorm in the ring, K split); else the
        scratch route in bf16, or fp32's CUDA cores."""
        return self.splits > 1

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def k_chunks(self) -> List[range]:
        """The K values each split sums, in the order their partials are
        added: all of K, once."""
        return [range(z * self.k_chunk, min(self.k, (z + 1) * self.k_chunk))
                for z in range(self.splits)]

    def k_slabs(self, z: int = 0) -> List[Tuple[int, int]]:
        """The (segment, offset in the gathered row) of each K slab split z
        walks, in order."""
        ks = self.k // self.segs
        return [(k0 // ks, k0 % ks) for k0 in self.k_chunks()[z][::self.slab]]


def _merge_seconds(f: Form, m: int, n: int, k: int, splits: int, sms: int) -> float:
    """The model's time of B8's product in form f with K in `splits` chunks
    (see above)."""
    ctas = _cdiv(m, f.bm) * _cdiv(n, f.bn) * splits
    chunk = _cdiv(_cdiv(k, f.bk), splits) * f.bk
    return _cdiv(ctas, sms * f.ctas) * (MERGE_CTA_S + f.bm * chunk * MERGE_VALUE_S)


@functools.lru_cache(maxsize=4096)
def merge_plan(m: int, n: int, k: int, segs: int, itemsize: int, sms: int,
               form: Optional[int] = None, splits: Optional[int] = None) -> MergePlan:
    """B8's launch: out (M, N) = LN(gather(A)) @ W (K, N) on a card of `sms`
    SMs, in the route, form and split of least modelled time, or in `form`
    and `splits` (bf16; a yardstick's way to compare them; splits = 1 is the
    scratch route). Raises ValueError where the kernels do not take the
    shapes (those of `linear_plan`) or the split (whole slabs a chunk, every
    chunk non-empty, at most MAX_SPLITS)."""
    base = linear_plan(m, n, k, segs, itemsize, sms)  # checks the shapes
    if itemsize == 4:
        if splits not in (None, 1):
            raise ValueError("merge_plan: fp32 does not split K")
        return MergePlan(m, n, k, segs, -1, base.tile, base.slab, k, (*base.grid, 1))

    def fits(i, z):
        slabs = k // FORMS[i].bk
        chunk = _cdiv(slabs, z)
        return (z <= MAX_SPLITS and _cdiv(slabs, chunk) == z
                and (z == 1 or chunk >= MERGE_MIN_SLABS))

    forms = [i for i, f in enumerate(FORMS) if (k // segs) % f.bk == 0]
    if any(FORMS[i].bk == 64 for i in forms):
        forms = [i for i in forms if FORMS[i].bk == 64]
    if form is not None and form not in forms:
        raise ValueError(f"merge_plan: form {form} does not take K / segs = {k // segs}")
    candidates = [(i, z) for i in ([form] if form is not None else forms) for z in MERGE_SPLITS
                  if (splits is None or z == splits) and fits(i, z)]
    if not candidates:
        raise ValueError(f"merge_plan: K = {k} takes no {splits} splits in forms {forms}")
    best, z = min(candidates, key=lambda c: (_merge_seconds(FORMS[c[0]], m, n, k, c[1], sms), c))
    if z == 1:  # the scratch route, in the form given or linear_plan's
        best = base.form if form is None else form
    f = FORMS[best]
    chunk = _cdiv(k // f.bk, z) * f.bk
    return MergePlan(m, n, k, segs, best, (f.bm, f.bn), f.bk, chunk,
                     (_cdiv(n, f.bn), _cdiv(m, f.bm), z))
