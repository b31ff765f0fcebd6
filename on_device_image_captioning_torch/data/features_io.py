"""HDF5 feature-store IO: precomputed Swin features keyed by image id.

A copy of the JAX package's `data/features_io.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

Matches the reference's store layout — one float dataset named
"{img_id}_features" per image (reference data_generator.py:98-160,
data/coco_dataloader.py:437-478) — so feature files are interchangeable between
the two frameworks.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class FeatureStore:
    def __init__(self, path: str, mode: str = "r"):
        import h5py

        # rdcc_nbytes=0 matches the reference's cache-off readers
        self._f = h5py.File(path, mode, rdcc_nbytes=0)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, img_id, features: np.ndarray) -> None:
        self._f.create_dataset(f"{img_id}_features", data=features)

    def read(self, img_id) -> np.ndarray:
        return np.asarray(self._f[f"{img_id}_features"], dtype=np.float32)

    def __contains__(self, img_id) -> bool:
        return f"{img_id}_features" in self._f

    def read_batch(
        self, img_ids: Sequence, pad_to: Optional[int] = None
    ) -> tuple[np.ndarray, list[int]]:
        """Stack a batch right-padding the token dim; returns (feats, num_pads)
        (reference data/coco_dataloader.py:437-478 + compute_num_pads)."""
        feats = [self.read(i) for i in img_ids]
        max_len = pad_to or max(f.shape[0] for f in feats)
        out = np.zeros((len(feats), max_len, feats[0].shape[-1]), np.float32)
        num_pads = []
        for i, f in enumerate(feats):
            out[i, : f.shape[0]] = f
            num_pads.append(max_len - f.shape[0])
        return out, num_pads
