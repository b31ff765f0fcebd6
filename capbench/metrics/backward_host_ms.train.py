"""The host's time in the XE step's backward: the program's `xe.backward`
span, mean over the window's steps before the profiled stretch
(`capbench/program_spans.py`)."""
from capbench import program_spans as ps


def read(view):
    return ps.child_mean_ms(view, ps.steps(view), "xe.backward")
