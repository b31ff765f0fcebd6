"""Kernel launches of one request's decode: the profiled kernels launched
inside each decode span, mean over the profiled requests."""
from capbench.readers import mean
from capbench.trace import kernels_within


def read(view):
    if view.trace is None:
        return None
    return mean([float(n) for n in kernels_within(view.trace, "decode")])
