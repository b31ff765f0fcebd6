"""The backbone and caption encoder of a request: CUDA events around each
request's `forward_enc`, their mean over the traced window's requests."""
from capbench.readers import mean


def read(view):
    return mean(view.device_ms.get("encode", []))
