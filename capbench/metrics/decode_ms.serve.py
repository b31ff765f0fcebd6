"""The decode of a request: CUDA events from the encoder's end on the card
until the caption lists are on the host, mean over the traced window's
requests."""
from capbench.readers import mean


def read(view):
    return mean(view.device_ms.get("decode", []))
