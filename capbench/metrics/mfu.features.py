"""The whole step's share of the card's bf16 peak over the traced window
(see `capbench/readers.py::mfu`)."""
from capbench.readers import mfu as read  # noqa: F401
