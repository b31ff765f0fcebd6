"""The kernels' share of their roofline in the profiled stretch (see
`capbench/readers.py::roofline`)."""
from capbench.readers import roofline as read  # noqa: F401
