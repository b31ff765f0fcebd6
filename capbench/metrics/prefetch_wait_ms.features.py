"""The host waiting on the prefetch thread for a feature batch's images:
the program's `features.wait` span, mean over the window's batches before
the profiled stretch (`capbench/program_spans.py`)."""
from capbench import program_spans as ps


def read(view):
    return ps.mean_ms(ps.batches(view, "wait"))
