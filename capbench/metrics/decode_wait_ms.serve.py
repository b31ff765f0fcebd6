"""The host blocked on the card in a request's decode: the sum of the
program's `decode.sync` spans (the exit test before each beam step; the
first waits for the encode too), mean over the window's requests before the
profiled stretch (`capbench/program_spans.py`)."""
from capbench import program_spans as ps


def read(view):
    return ps.child_mean_ms(view, ps.requests(view), "decode.sync")
