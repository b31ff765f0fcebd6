"""The host's work on a feature batch once it is on the host (the upcast,
the cast to the store's dtype and the store's writes), with nothing queued
on the card: the program's `features.store` span, mean over the window's
batches before the profiled stretch (`capbench/program_spans.py`)."""
from capbench import program_spans as ps


def read(view):
    return ps.mean_ms(ps.batches(view, "store"))
