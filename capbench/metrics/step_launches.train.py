"""Kernel launches of one XE step: the profiled stretch's kernels over its
steps (the stretch starts and ends on a synchronise)."""


def read(view):
    if view.trace is None or view.profiled_iters == 0:
        return None
    return len(view.trace["kernels"]) / view.profiled_iters
