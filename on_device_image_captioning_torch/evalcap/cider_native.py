"""ctypes binding for the native C++ CIDEr scorer (the repo's `native/cider.cc`),
the counterpart of the JAX package's `evalcap/cider_native.py`.

Drop-in accelerated replacement for `evalcap.cider.CiderCorpus` on the SCST
host-reward path: the reward runs between every sampling call and gradient
step (reference losses/reward.py:30-89); the C++ scorer removes the Python
dict arithmetic from that loop. Numerics match the Python scorer to float32
precision.

The shared library builds on first use with `g++ -O3` into the package's
git-ignored build directory (`build/libcider-<hash of the source>.so`), never
next to the source; `NativeCiderCorpus.available()` reports whether it built,
so callers can fall back to the Python scorer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SRC = PACKAGE_DIR.parent / "native" / "cider.cc"
BUILD_DIR = PACKAGE_DIR / "build"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_RS, _US = "\x1e", "\x1f"


def library_path() -> pathlib.Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcider-{digest}.so"


def _build() -> Optional[pathlib.Path]:
    try:
        lib = library_path()
    except OSError:  # no source in this checkout
        return None
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a name of its own, then renamed: processes that build at
    # once never load a half-written file
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(SRC), "-o", str(tmp)],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.cider_corpus_new.restype = ctypes.c_void_p
        lib.cider_corpus_new.argtypes = [ctypes.c_char_p]
        lib.cider_corpus_free.restype = None
        lib.cider_corpus_free.argtypes = [ctypes.c_void_p]
        lib.cider_corpus_size.restype = ctypes.c_int
        lib.cider_corpus_size.argtypes = [ctypes.c_void_p]
        lib.cider_score.restype = None
        lib.cider_score.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


class NativeCiderCorpus:
    """Same interface as evalcap.cider.CiderCorpus.score_hypotheses."""

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def __init__(self, refs_per_image: Sequence[List[str]]):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native cider library unavailable (g++ could not build {SRC})")
        self._lib = lib
        blob = _RS.join(_US.join(refs) for refs in refs_per_image).encode("utf-8")
        self._handle = lib.cider_corpus_new(blob)
        if lib.cider_corpus_size(self._handle) != len(refs_per_image):
            raise ValueError("the native corpus did not take every image's references "
                             "(a reference holds a \\x1e or \\x1f character?)")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.cider_corpus_free(self._handle)
            self._handle = None

    def score_hypotheses(
        self, hypotheses: Sequence[str], ref_indices: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        n = len(hypotheses)
        if ref_indices is None:
            ref_indices = range(n)
        idx = (ctypes.c_int * n)(*[int(i) for i in ref_indices])
        out = (ctypes.c_float * n)()
        blob = _RS.join(hypotheses).encode("utf-8")
        self._lib.cider_score(self._handle, blob, idx, n, out)
        return np.asarray(out, dtype=np.float32)
