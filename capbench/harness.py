"""What every entry shares: the spans of a traced run, the profiled stretch,
and the view a per-layer metric's reader gets.

Spans are the benchmark's own, taken around its calls into the program's
layers. A host span times with the host clock; a device span records a pair
of CUDA events, read once the window has closed. Each is kept with the
window iteration it belongs to. Spans are kept only in a `--trace 1` run; in
a `--trace 0` run every call here is a no-op.

The profiler covers a short steady stretch inside the window: it starts at
the first iteration past the window's middle and stops after
`profile_iters` iterations. Inside it each span is also a
`torch.profiler.record_function` range named "capbench.<span>", which the
trace reduction reads. Once attached, the profiler slows the host's
launches for the rest of the process, so the rates and span means of a
traced run are read from the iterations before the stretch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch


class Tracer:
    def __init__(self, enabled: bool, profile_iters: int = 4):
        self.enabled = enabled
        self.profile_iters = profile_iters
        self.profile_first = 0  # the window iteration the stretch starts at
        self.index = 0  # the window iteration running
        self.profile_started_s = None  # seconds into the window the stretch started
        self.host: Dict[str, List[tuple]] = {}
        self._events: Dict[str, list] = {}
        self._prof = None
        self._prof_left = 0
        self.profiled = None  # the profiler once the stretch has ended
        self.profiled_iters = 0
        self.profile_wall_s = 0.0
        self._prof_t0 = 0.0

    # -- spans ---------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A host-clock span; sync=True ends it on a device synchronise."""
        if not self.enabled:
            yield
            return
        with self._annotate(name):
            t0 = time.perf_counter()
            yield
            if sync:
                torch.cuda.synchronize()
            self.host.setdefault(name, []).append(
                (self.index, (time.perf_counter() - t0) * 1e3))

    @contextlib.contextmanager
    def device_span(self, name: str):
        """A span timed by CUDA events on the current stream."""
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with self._annotate(name):
            start.record()
            yield
            end.record()
        self._events.setdefault(name, []).append((self.index, start, end))

    def _annotate(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function("capbench." + name)

    def device_ms(self) -> Dict[str, List[tuple]]:
        """Every device span's (iteration, milliseconds) (synchronises)."""
        torch.cuda.synchronize()
        return {k: [(i, a.elapsed_time(b)) for i, a, b in v] for k, v in self._events.items()}

    # -- the profiled stretch --------------------------------------------------

    def iteration(self, index: int, elapsed: float, seconds: float) -> None:
        """Called by the window loop before its iteration `index`."""
        if not self.enabled:
            return
        self.index = index
        if self._prof is not None:
            self._prof_left -= 1
            if self._prof_left == 0:
                self._stop(self.profile_iters)
            return
        if self.profiled is None and elapsed >= 0.5 * seconds:
            self.profile_first = index
            self._start(time.perf_counter() - elapsed)

    def _start(self, window_start: float) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()  # the earlier iterations' work is done
        self.profile_started_s = time.perf_counter() - window_start
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._prof_left = self.profile_iters
        self._prof_t0 = time.perf_counter()

    def _stop(self, done: int) -> None:
        torch.cuda.synchronize()
        self.profile_wall_s = time.perf_counter() - self._prof_t0
        self._prof.__exit__(None, None, None)
        self.profiled, self._prof = self._prof, None
        self.profiled_iters = done

    def close(self) -> None:
        """Ends a stretch the window cut short."""
        if self._prof is not None:
            self._stop(self.profile_iters - self._prof_left + 1)


@dataclasses.dataclass
class LayerView:
    """What a per-layer metric's reader reads. `trace` is the reduced
    profile (`capbench/trace.py::reduce`) or None. `host_ms` and `device_ms`
    hold each span's milliseconds in the traced window's iterations before
    the profiled stretch, which last `window_s`; `window_work` and
    `profiled_work` are the entry's frozen costs (`capbench/costs.py`) of
    those iterations and of the profiled stretch's: "items", "macs" and
    "bound_s"."""

    host_ms: Dict[str, List[float]]
    device_ms: Dict[str, List[float]]
    trace: Optional[dict]
    window_s: float
    window_work: Dict[str, float]
    profiled_work: Dict[str, float]
    profiled_iters: int
