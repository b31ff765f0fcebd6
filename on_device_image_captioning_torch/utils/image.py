"""Image preprocessing: PIL load -> RGB -> resize on the host, scaling to
[0, 1] and the ImageNet normalization on the tensor's device (counterpart of
the JAX package's `utils/image.py`; reference utils/image_utils.py:5-23)."""
from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image_rgb(path: str, size: int) -> np.ndarray:
    """Decode + resize on host. Returns uint8 (size, size, 3) NHWC."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode != "RGB":
            im = im.convert("RGB")
        im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def preprocess_batch(paths, size: int, num_threads: int = 8) -> np.ndarray:
    """Host-side batch decode; returns uint8 (B, size, size, 3). JPEG decode is
    GIL-releasing PIL C code, so a small thread pool parallelizes it."""
    if len(paths) <= 1 or num_threads <= 1:
        return np.stack([load_image_rgb(p, size) for p in paths])
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(num_threads, len(paths))) as pool:
        return np.stack(list(pool.map(lambda p: load_image_rgb(p, size), paths)))


def normalize_on_device(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC (B, H, W, 3) -> normalized float32 on the same device."""
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"normalize_on_device: want uint8 images, got {images_u8.dtype}")
    dev = images_u8.device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    x = images_u8.float() / 255.0
    return (x - mean) / std
