"""The program's own spans, as the per-layer readers of
`capbench/metrics/*` take them: the records of the program's span recorder
(`on_device_image_captioning_torch/utils/profiling.py`), read through the
program's module.

A traced run profiles a stretch from the window's middle, and the profiler
slows the host from then on, so the readers take the window's iterations
before it: the root spans that started within `view.window_s` (the window's
seconds before the stretch) before the end of the last record made before
the stretch. That end precedes the stretch's start by the harness's
synchronise alone, where the profiler's first start can take seconds, so
the window's first iterations stay in and set-up's, which ended before the
window began, stay out. Every function returns None where the recorder
holds nothing (recording off, or a program without the recorder), where no
stretch was profiled, or where the ring no longer holds the whole window.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def _window(view) -> Optional[list]:
    """The recorder's records that started in the window before the profiled
    stretch."""
    try:
        from on_device_image_captioning_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    recs = records()
    first = next((i for i, r in enumerate(recs) if r.profiled), 0)
    if not first:
        return None
    before = recs[:first]  # the ring keeps records in the order they ended
    start = max(r.end_ns for r in before) - int(view.window_s * 1e9)
    if len(recs) >= profiling.CAPACITY and recs[0].end_ns > start:
        return None  # the ring has dropped records of the window
    return [r for r in before if r.start_ns >= start]


def roots(view, name: str) -> Optional[List]:
    """The root spans named `name` of the window before the stretch, or None
    where there are none."""
    recs = _window(view)
    if not recs:
        return None
    return [r for r in recs if r.name == name and r.parent is None] or None


def children(view, parents: List, name: str) -> Dict[int, List]:
    """{parent id: its children named `name`} for each of `parents`."""
    out = {p.id: [] for p in parents}
    for r in _window(view) or []:
        if r.name == name and r.parent in out:
            out[r.parent].append(r)
    return out


def mean_ms(spans: Optional[List]) -> Optional[float]:
    """The mean host milliseconds of `spans`."""
    if not spans:
        return None
    return sum(s.ms for s in spans) / len(spans)


def child_mean_ms(view, parents: Optional[List], name: str) -> Optional[float]:
    """The mean over `parents` of the host milliseconds of their children
    named `name`, summed within each parent."""
    if not parents:
        return None
    kids = children(view, parents, name)
    return sum(sum(c.ms for c in kids[p.id]) for p in parents) / len(parents)


def requests(view) -> Optional[List]:
    """The program's `decode` spans of the window's requests before the
    stretch."""
    return roots(view, "decode")


def steps(view) -> Optional[List]:
    """The program's `xe` spans of the window's steps before the stretch."""
    return roots(view, "xe")


def batches(view, name: str) -> Optional[List]:
    """The program's `features.<name>` spans of the window's batches before
    the stretch."""
    return roots(view, "features." + name)
