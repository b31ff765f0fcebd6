"""The share of a request's beam-search steps that the program replayed
from CUDA graphs, in %: its `decode_graph_replay` counter inside the
request's `decode` span over the steps the request ran there (its
`decode.start` and `decode.step` children, and the final ranking), over
the window's requests before the profiled stretch
(`capbench/program_spans.py`). None where the program has no graphed
decode (`decode/graphs.py`) or recorded no request."""
from capbench import program_spans as ps


def read(view):
    try:
        from on_device_image_captioning_torch.decode import graphs  # noqa: F401
    except ImportError:
        return None
    decodes = ps.requests(view)
    if not decodes:
        return None
    starts = ps.children(view, decodes, "decode.start")
    steps = ps.children(view, decodes, "decode.step")
    run = sum(len(starts[d.id]) + len(steps[d.id]) + 1 for d in decodes)
    return 100.0 * sum(d.counts.get("decode_graph_replay", 0) for d in decodes) / run
