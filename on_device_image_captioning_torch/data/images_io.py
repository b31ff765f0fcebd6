"""Preprocessed-image HDF5 store.

A copy of the JAX package's `data/images_io.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

Capability parity with the reference's optional preprocessed-images HDF5 path
(reference data/coco_dataset.py:44-51 `preproc_images_hdf5_filepath`,
data/coco_dataloader.py:70-76): decode+resize once offline, then train/eval read
fixed-size uint8 tensors instead of re-decoding JPEGs every epoch.

Layout: one uint8 dataset "{img_id}" of shape (size, size, 3) per image (NHWC;
normalization stays on device, utils/image.py)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


class PreprocessedImageStore:
    def __init__(self, path: str, mode: str = "r"):
        import h5py

        self._f = h5py.File(path, mode, rdcc_nbytes=0)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __contains__(self, img_id) -> bool:
        return str(img_id) in self._f

    def write(self, img_id, image_u8: np.ndarray) -> None:
        assert image_u8.dtype == np.uint8 and image_u8.ndim == 3
        self._f.create_dataset(str(img_id), data=image_u8)

    def read(self, img_id) -> np.ndarray:
        return np.asarray(self._f[str(img_id)])

    def read_batch(self, img_ids: Sequence) -> np.ndarray:
        return np.stack([self.read(i) for i in img_ids])


def build_store(
    path: str, records: Sequence[dict], size: int, verbose: bool = True
) -> None:
    """Offline preprocessing pass: decode+resize every record's image."""
    from ..utils.image import load_image_rgb

    with PreprocessedImageStore(path, "w") as store:
        for i, r in enumerate(records):
            store.write(r["img_id"], load_image_rgb(r["img_path"], size))
            if verbose and (i + 1) % 1000 == 0:
                print(f"preprocessed {i + 1}/{len(records)}", flush=True)
