"""The host's enqueue of a request's decode: the program's `decode` span
less its `decode.sync` children (the host blocked on the card), mean over
the window's requests before the profiled stretch (`capbench/program_spans.py`)."""
from capbench import program_spans as ps


def read(view):
    decodes = ps.requests(view)
    wait = ps.child_mean_ms(view, decodes, "decode.sync")
    return None if wait is None else ps.mean_ms(decodes) - wait
