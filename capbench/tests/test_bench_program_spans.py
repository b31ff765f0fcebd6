"""The readers of the program's own spans (`capbench/program_spans.py` and
the metrics that use it), on each entry at a CPU's size: a traced window,
its profiled stretch included, and the view `run.py` builds from it. CUDA
events and the synchronise are stood in for by the host clock."""
import math
import time

import pytest
import torch

from capbench import program_spans as ps
from capbench import trace as trace_mod
from capbench.harness import LayerView, Tracer
from capbench.manifest import Manifest
from capbench.tests.tiny import tiny

SEED = 2**31 + 977
READERS = {
    "serve_b32_beam3_L20": ["decode_host_ms.serve", "decode_wait_ms.serve", "decode_casts.serve"],
    "train_xe_b16": ["forward_host_ms.train", "backward_host_ms.train",
                     "optimizer_host_ms.train"],
    "features_b32": ["drain_host_ms.features", "prefetch_wait_ms.features"],
}


class _HostEvent:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def host_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, so that a window sees its iterations when other
    test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def recording():
    from on_device_image_captioning_torch.utils import profiling

    profiling.clear()
    yield profiling
    profiling.set_tracing(True)
    profiling.clear()


class _SecondIterationStretch(Tracer):
    """The harness's tracer with its profiled stretch started at the window's
    second iteration, whatever the host's speed."""

    def iteration(self, index, elapsed, seconds):
        super().iteration(index, elapsed, seconds if index < 1 else 0.0)


def traced_view(cell, seconds=4.0):
    """A traced window of the cell's entry, the view `run.py` gives its
    readers, the tracer, and the number of each of the benchmark's own spans
    that set-up recorded."""
    cfg, traffic = tiny(cell)
    tracer = _SecondIterationStretch(True, traffic.get("profile_iters", 4))
    entry = Manifest().entry_class(traffic["entry"])(cfg, traffic, SEED, "cpu", tracer)
    entry.setup()
    in_setup = {k: len(v) for k, v in {**tracer.host, **tracer._events}.items()}
    res = entry.window(seconds)
    reduced = None
    if tracer.profiled is not None:
        reduced = trace_mod.reduce(trace_mod.export_events(tracer.profiled),
                                   tracer.profile_wall_s)
    before = tracer.profile_first if tracer.profiled is not None else res["iters"]
    before_s = tracer.profile_started_s if tracer.profiled is not None else res["window_s"]

    def early(spans):
        return {k: [ms for i, ms in v if i < before] for k, v in spans.items()}

    view = LayerView(host_ms=early(tracer.host), device_ms=early(tracer.device_ms()),
                     trace=reduced, window_s=before_s, window_work=entry.work(0, before),
                     profiled_work=entry.work(tracer.profile_first, tracer.profiled_iters),
                     profiled_iters=tracer.profiled_iters)
    return view, tracer, in_setup


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_give_numbers(cell, host_events, recording):
    m = Manifest()
    view, tracer, _ = traced_view(cell)
    assert tracer.profiled is not None  # the stretch ran, and its records are left out
    listed = [x["name"] for x in m.per_layer(cell) if x["source"] in ("program_span",
                                                                     "program_counter")]
    assert set(READERS[cell]) <= set(listed)
    values = {name: m.reader(name)(view) for name in READERS[cell]}
    assert all(v is not None and math.isfinite(v) and v >= 0 for v in values.values()), values
    if cell == "train_xe_b16":  # the parts lie inside the benchmark's own step span
        n = len(ps.steps(view))  # the last n steps before the stretch
        step = sum(view.host_ms["step"][-n:]) / n
        assert 0 < sum(values.values()) <= step
    if cell == "serve_b32_beam3_L20":
        assert values["decode_casts.serve"] == 0  # the tiny cells compute in fp32
        assert values["decode_wait_ms.serve"] > 0


WINDOW = {  # the benchmark's own span an iteration, and the program's roots of it
    "serve_b32_beam3_L20": ("decode", ps.requests),
    "train_xe_b16": ("step", ps.steps),
    "features_b32": ("backbone", lambda view: ps.batches(view, "backbone")),
}


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_take_the_window_without_setup(cell, host_events, recording):
    """The readers' spans are the window's iterations before the stretch,
    all of them, and none of set-up's."""
    key, program = WINDOW[cell]
    view, _, in_setup = traced_view(cell)
    ours = {**view.host_ms, **view.device_ms}[key]
    assert in_setup[key] > 0 and len(ours) > in_setup[key]
    assert len(program(view)) == len(ours) - in_setup[key]


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_give_none_with_recording_off(cell, host_events, recording):
    recording.set_tracing(False)
    m = Manifest()
    view, _, _ = traced_view(cell, seconds=0.3)
    assert all(m.reader(name)(view) is None for name in READERS[cell])


def test_readers_give_none_without_the_recorder(monkeypatch, recording):
    """A program without the recorder (the benchmark laid over an older
    program): every reader returns None and raises nothing."""
    monkeypatch.delattr(recording, "records")
    view = LayerView(host_ms={"step": [1.0]}, device_ms={"decode": [1.0], "backbone": [1.0]},
                     trace=None, window_s=1.0, window_work={}, profiled_work={},
                     profiled_iters=0)
    m = Manifest()
    assert all(m.reader(name)(view) is None for names in READERS.values() for name in names)
