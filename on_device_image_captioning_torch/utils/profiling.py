"""Profiling and observability (counterpart of the JAX package's
`utils/profiling.py`).

The reference's only observability is flushed prints of loss / lr /
sec-per-iter (reference train.py:183-246). Here:

- `trace(log_dir)`: a `torch.profiler.profile` over the block, CPU and (where
  there is one) CUDA activity, written to `log_dir` as a Chrome trace that
  TensorBoard's profiler plugin and chrome://tracing read;
- `annotate(name)`: a named region in that trace (`record_function`);
- `StepTimer`: sec-per-iter accounting with a warmup skip;
- `MetricsLogger`: the reference's print logging, structured (stdout and/or
  a JSONL file for machines).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; the trace lands in `log_dir` when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region appearing in profiler timelines (use around steps/phases)."""
    from torch.profiler import record_function

    return record_function(name)


class StepTimer:
    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._seen = 0
        self._total = 0.0
        self._last: Optional[float] = None

    def tick(self) -> float:
        """Call once per step; returns seconds since previous tick (0 on first)."""
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        self._seen += 1
        if self._seen > self.warmup:
            self._total += dt
        return dt

    @property
    def sec_per_iter(self) -> float:
        steps = max(self._seen - self.warmup, 1)
        return self._total / steps


class MetricsLogger:
    """print(..., flush=True) semantics (reference train.py:40) plus optional
    JSONL sink."""

    def __init__(self, jsonl_path: Optional[str] = None, stdout: bool = True):
        self.stdout = stdout
        self._f = open(jsonl_path, "a") if jsonl_path else None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self.stdout:
            parts = " ".join(f"{k} {v:.6g}" for k, v in metrics.items())
            print(f"it {step} {parts}", flush=True)
        if self._f:
            self._f.write(json.dumps({"step": step, **metrics}) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
