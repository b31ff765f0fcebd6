"""The device's idle share of the profiled stretch (see
`capbench/readers.py::idle`)."""
from capbench.readers import idle as read  # noqa: F401
