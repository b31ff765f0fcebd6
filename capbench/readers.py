"""The arithmetic the per-layer readers share (`capbench/metrics/`).

- roofline: the least time the profiled stretch's work needs
  (`capbench/costs.py`, by function) over the summed time of the stretch's
  kernels, in percent;
- mfu: 2 x the MACs of the traced window's iterations before the profiled
  stretch over their seconds, over the published dense bf16 peak of one
  H100 (989 TFLOP/s), in percent;
- idle: the share of the profiled stretch's timeline with no device
  operation running, in percent.

Each returns None where its run has nothing to read (no profile, no work).
"""
from __future__ import annotations

from typing import List, Optional

from .costs import PEAK_BF16_FLOPS
from .harness import LayerView


def roofline(view: LayerView) -> Optional[float]:
    t = view.trace
    if t is None or t["kernel_s"] <= 0 or view.profiled_work["bound_s"] <= 0:
        return None
    return 100.0 * view.profiled_work["bound_s"] / t["kernel_s"]


def mfu(view: LayerView) -> Optional[float]:
    if view.window_s <= 0 or view.window_work["macs"] <= 0:
        return None
    return 100.0 * 2 * view.window_work["macs"] / view.window_s / PEAK_BF16_FLOPS


def idle(view: LayerView) -> Optional[float]:
    t = view.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
