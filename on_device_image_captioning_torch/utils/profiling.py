"""Profiling and observability (counterpart of the JAX package's
`utils/profiling.py`).

The reference's only observability is flushed prints of loss / lr /
sec-per-iter (reference train.py:183-246). Here:

- `span(name, **attrs)` and `count(name, n)`: the program's one span and
  counter recorder (below);
- `trace(log_dir)`: a `torch.profiler.profile` over the block, CPU and (where
  there is one) CUDA activity, written to `log_dir` as a Chrome trace that
  TensorBoard's profiler plugin and chrome://tracing read; every span inside
  it lies on the trace's timeline as "odic.<name>";
- `StepTimer`: sec-per-iter accounting with a warmup skip;
- `MetricsLogger`: the reference's print logging, structured (stdout and/or
  a JSONL file for machines).

The recorder. Recording is on by default. A span costs about 1.5 us of
host time in a tight loop and about 15 us inside the serving decode's host
loop (an H100 machine's host). A span takes the host clock (`time.perf_counter_ns`) at
its start and end and is kept, once it has ended, as a `Span` record in a
ring of the last `CAPACITY` records (`records()`, `clear()`); a record holds
its id, its parent's id (the innermost span open in the same thread when it
started), its thread, its attributes, whether a torch profiler was attached
when it started, and the counts added inside it, its children's included.
`count(name, n)` adds to the calling thread's counters; a span takes what
they gained between its start and its end. A count is a few dictionary
updates, because the decode calls it for every weight cast.

- Under an attached torch profiler a span also enters
  `torch.profiler.record_function("odic." + name)`, so it lies on the
  profile's timeline beside the kernels it launched; without one it never
  does (a `record_function` costs about six times a bare span).
- `set_tracing(False)` turns the recorder off: `span` returns one shared
  no-op and `count` returns at once. `set_tracing(device=True)` also records
  a CUDA event pair on the current stream per span (`Span.device_ms`),
  read when asked for.
- Under `torch.compiler.is_compiling()` (`torch.compile`, `torch.export`:
  `deploy/aot.py`) both do nothing, so traced graphs hold no trace of them.

The program's spans (a parent, then its children) and counters:

- `api.Captioner.forward_enc`: `encode`.
- `decode/beam_search.py::ensemble_beam_search`: `decode`; `decode.start`
  (the decoder states and step 1), `decode.sync` (attribute `t`: the exit
  test before step t, the one host sync a step), `decode.step` (attribute
  `t`: growing the caches and enqueueing beam step t).
  `captions_from_result`: `captions` (the result's copy to the host).
- `train/train_step.py::make_xe_step`: `xe`; `xe.forward` (the loss),
  `xe.backward`, `xe.optimizer`.
- `train/train_step.py::make_scst_fused_step`: `scst`; `scst.encoder`,
  `scst.sampling`, `scst.reward`, `scst.rescore` (the teacher-forced
  forward), `scst.backward`, `scst.optimizer`.
- `cli/generate_features.py::generate_features`, one each a batch:
  `features.wait` (the prefetch queue), `features.backbone` (enqueueing the
  backbone), `features.fetch` (the features' copy to the host, which waits
  for the card), `features.store` (the host's upcast, cast and store writes).
- Counters: `weight_cast` and `weight_cast_bytes` (the bytes the casts
  read), each cast of a weight or bias to another dtype in
  `models/common.py::linear`; `decode_graph_capture` and
  `decode_graph_replay`, each beam-search step captured into or replayed
  from a CUDA graph (`decode/graphs.py`; a replay also adds back the counts
  its capture made, so the casts a graph runs are counted as they run).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

CAPACITY = 65536  # the records the ring keeps
PREFIX = "odic."  # the spans' names on a profiler's timeline

_clock = time.perf_counter_ns
_profiler_on = torch._C._autograd._profiler_enabled
_compiling = torch.compiler.is_compiling
_ids = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_on = True
_device = False


class _Stack(threading.local):
    """A thread's open spans and its counters since the process started
    (only this thread writes them)."""

    def __init__(self):
        self.open: List["Span"] = []
        self.thread = threading.get_ident()
        self.counts: Dict[str, int] = {}


_stack = _Stack()


class Span:
    """One span: a context manager while open, a record once it has ended.
    start_ns / end_ns are `time.perf_counter_ns` readings; end_ns is 0 while
    open. `counts` is what was counted inside it, its children's included:
    the thread's counters at its end less those at its start."""

    __slots__ = ("id", "parent", "name", "thread", "attrs", "profiled", "start_ns", "end_ns",
                 "_range", "_events", "_before", "_after")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs
        self.end_ns = 0
        self._after = None

    def __enter__(self):
        stack = _stack
        open_ = stack.open
        self.id = next(_ids)
        self.parent = open_[-1].id if open_ else None
        self.thread = stack.thread
        self._before = dict(stack.counts)
        self.profiled = _profiler_on()
        self._range = None
        if self.profiled:
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._events = None
        if _device and torch.cuda.is_available():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        open_.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = _stack
        stack.open.pop()
        self._after = dict(stack.counts)
        _ring.append(self)
        return False

    @property
    def counts(self) -> Dict[str, int]:
        """What was counted in this thread while the span was open (empty
        while it is open)."""
        if self._after is None:
            return {}
        before = self._before
        return {k: v - before.get(k, 0) for k, v in self._after.items()
                if v != before.get(k, 0)}

    @property
    def ms(self) -> float:
        """Host milliseconds from start to end."""
        return (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two CUDA events (waits for the
        second); None where it recorded none (`set_tracing(device=True)`)."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])


class _NoSpan:
    """The shared span of a recorder that is off, or inside a traced graph."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A span named `name` (recorded with the `attrs`, small values) around
    the `with` block; a shared no-op where the recorder is off or a graph is
    being traced."""
    if not _on or _compiling():
        return _NO_SPAN
    return Span(name, attrs or None)


def count(name: str, n: int = 1, nbytes: Optional[int] = None) -> None:
    """Add n to the counter `name`, and `nbytes` (where given) to the counter
    `name + "_bytes"`, of the calling thread: the spans open in it see the
    counts when they end."""
    if not _on or _compiling():
        return
    c = _stack.counts
    c[name] = c.get(name, 0) + n
    if nbytes is not None:
        key = name + "_bytes"
        c[key] = c.get(key, 0) + nbytes


@contextlib.contextmanager
def set_aside():
    """Counts made in the calling thread inside the block go to the dict it
    yields instead of the thread's counters, so no span sees them (a CUDA
    graph's capture counts what each replay adds back,
    `decode/graphs.py`)."""
    stack = _stack
    kept = stack.counts
    stack.counts = {}
    try:
        yield stack.counts
    finally:
        stack.counts = kept


def set_tracing(enabled: Optional[bool] = None, device: Optional[bool] = None) -> None:
    """Turn the recorder on or off (`enabled`) and the CUDA event pair a span
    on or off (`device`); None leaves a setting as it is."""
    global _on, _device
    if enabled is not None:
        _on = bool(enabled)
    if device is not None:
        _device = bool(device)


def tracing() -> bool:
    """Whether the recorder is on."""
    return _on


def records() -> List[Span]:
    """The ring's records, oldest first, in the order they ended."""
    return list(_ring)


def clear() -> None:
    """Drop every record (spans still open are kept open)."""
    _ring.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; the trace lands in `log_dir` when it ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


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
