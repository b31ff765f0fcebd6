"""Window layouts of the Swin token grid: partition, reverse, the
shift-to-shift transition permutation, and the index arithmetic the CUDA
kernels use in its place.

A window layout stores a (res, res) token grid, rolled cyclically by
(-shift, -shift), as (B * nW, window * window, C) rows. The window-resident
backbone keeps activations in this layout from the patch embed to the last
stage; moving between two shift layouts is one permutation of rows
(`window_transition_perm`, as the JAX package's `models/swin.py:81`).

`source_rows` is the numpy mirror of `csrc/window_layout.cuh::map_row`: the
kernels compute a source row per output row instead of reading a permutation
table or multiplying by a one-hot matrix. The CPU tests hold it to
`window_transition_perm`, `window_partition` and the 2x2 merge order, which a
CUDA source cannot be held to without a card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """Inverse of window_partition."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // window // window)
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def window_transition_perm(res: int, window: int, from_shift: int, to_shift: int) -> np.ndarray:
    """perm[i] = flat index in the FROM layout of the token that position i of
    the TO layout holds; both layouts flatten (nW, window, window) row-major
    over a (res, res) grid rolled by (-shift, -shift)."""
    grid = np.arange(res * res).reshape(res, res)

    def layout(shift):
        rolled = np.roll(grid, (-shift, -shift), axis=(0, 1))
        return (
            rolled.reshape(res // window, window, res // window, window)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )

    src = layout(from_shift)  # FROM position j holds spatial token src[j]
    dst = layout(to_shift)  # TO position i needs spatial token dst[i]
    inv = np.empty_like(src)
    inv[src] = np.arange(src.size)
    return inv[dst].astype(np.int64)


def _window_row(y, x, res: int, window: int):
    wn = res // window
    return ((y // window) * wn + x // window) * (window * window) + (y % window) * window + x % window


def _window_pos(r, res: int, window: int):
    n, wn = window * window, res // window
    w, p = r // n, r % n
    return (w // wn) * window + p // window, (w % wn) * window + p % window


def source_rows(kind: str, res: int, window: int, delta: int = 0, seg: int = 0) -> np.ndarray:
    """Per-image source row of every output row, as `map_row` computes it on
    the card. kind "transition": window layout -> window layout with
    delta = (to_shift - from_shift) mod res; "raster": raster rows -> window
    layout; "merge": window layout of a res grid -> window layout of the
    res/2 grid, seg picking the 2x2 neighbour (row offset seg & 1, column
    offset seg >> 1)."""
    if kind == "merge":
        y, x = _window_pos(np.arange((res // 2) ** 2), res // 2, window)
        return _window_row(2 * y + (seg & 1), 2 * x + (seg >> 1), res, window)
    y, x = _window_pos(np.arange(res * res), res, window)
    if kind == "raster":
        return y * res + x
    if kind == "transition":
        return _window_row((y + delta) % res, (x + delta) % res, res, window)
    raise ValueError(f"source_rows: unknown kind {kind!r}")
