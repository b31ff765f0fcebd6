"""The host's time in the XE step's forward: the program's `xe.forward`
span, mean over the window's steps before the profiled stretch
(`capbench/program_spans.py`)."""
from capbench import program_spans as ps


def read(view):
    return ps.child_mean_ms(view, ps.steps(view), "xe.forward")
