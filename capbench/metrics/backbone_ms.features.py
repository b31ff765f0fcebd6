"""The backbone of a feature batch: CUDA events around each batch's call of
the backbone inside `generate_features`, mean over the traced window's
batches."""
from capbench.readers import mean


def read(view):
    return mean(view.device_ms.get("backbone", []))
