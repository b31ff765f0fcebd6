"""The reader of `decode_graph_share.serve`, on the serving entry at a CPU's
size: eager decoding reads 0, a decode replayed from graphs reads 100, and a
program without a graphed decode reads None. The traced window and its
stand-ins for CUDA events are those of `test_bench_program_spans.py`."""
import math
import sys

from capbench import program_spans as ps
from capbench.manifest import Manifest
from capbench.tests.test_bench_program_spans import (  # noqa: F401  (fixtures)
    host_events, one_thread, recording, traced_view)

CELL = "serve_b32_beam3_L20"
NAME = "decode_graph_share.serve"


def test_graph_share_is_listed_and_reads_zero_eagerly(host_events, recording):
    """The CPU decodes eagerly, so no step of a window request is replayed."""
    m = Manifest()
    listed = [x["name"] for x in m.per_layer(CELL) if x["source"] == "program_counter"]
    assert NAME in listed
    view, tracer, _ = traced_view(CELL)
    assert tracer.profiled is not None
    value = m.reader(NAME)(view)
    assert value is not None and math.isfinite(value)
    assert value == 0


def test_graph_share_reads_replayed_steps(host_events, recording, monkeypatch):
    """With the graphs engaged (on `graphs.HostGraph`, the CPU's stand-in
    for CUDA graphs) every step of every window request is replayed: 100%.
    The first window request captures, then replays, so it counts too."""
    from on_device_image_captioning_torch.decode import graphs

    monkeypatch.setattr(graphs, "engages", lambda *a: True)
    monkeypatch.setattr(graphs, "cuda_graphs", graphs.host_graphs)
    view, _, _ = traced_view(CELL)
    decodes = ps.requests(view)
    assert any(d.counts.get("decode_graph_capture") for d in decodes)
    assert Manifest().reader(NAME)(view) == 100.0


def test_graph_share_is_none_without_graphed_decode(host_events, recording, monkeypatch):
    """A program without `decode/graphs.py` (the benchmark laid over an
    older program) reads None, whatever it recorded."""
    from on_device_image_captioning_torch import decode

    view, _, _ = traced_view(CELL, seconds=0.5)
    monkeypatch.delattr(decode, "graphs")
    monkeypatch.setitem(sys.modules, "on_device_image_captioning_torch.decode.graphs", None)
    assert Manifest().reader(NAME)(view) is None
