"""Weight and bias casts to the compute dtype in a request's decode: the
program's `weight_cast` counter inside its `decode` span, mean over the
window's requests before the profiled stretch (`capbench/program_spans.py`)."""
from capbench import program_spans as ps


def read(view):
    decodes = ps.requests(view)
    if not decodes:
        return None
    return sum(d.counts.get("weight_cast", 0) for d in decodes) / len(decodes)
