"""The launch plan of the backbone's shared product (`csrc/fused_linear.cuh`):
which tile each product launches in, decided on the host from the shapes and
the card's SM count, and handed to the C launchers of B4, B5, B8, B9b and
B10a / B10b.

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
tile for every SM, if any has; of these the least time. K is never split: at
every M of the main path (576 rows and up) the smallest tile gives the card
72 CTAs or more (108 on the blocks' products).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

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
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def form_for(x: torch.Tensor, m: int, n: int, k: int, segs: int = 1) -> int:
    """The form index a wrapper passes for a product on x's card and dtype."""
    return linear_plan(m, n, k, segs, x.element_size(), _sm_count(x.device)).form
