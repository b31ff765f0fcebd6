"""Build and load the port's hand-written kernels at their first launch.

CUDA sources under `csrc/` are compiled by `nvcc` into shared libraries with a
plain C interface and loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). Triton kernels compile through Triton's own JIT, with its
cache pointed into the same build directory. The build directory lives inside
the package and is listed in `.gitignore`; nothing prebuilt is committed.

Nothing here runs at import time: `load_cuda_library` is called by a
wrapper right before its first launch on a CUDA tensor.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# seconds spent compiling, by kernel source name (read by chip_smoke.py)
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source at first use"
    )


def check_cuda_tensors(*tensors: torch.Tensor) -> None:
    """Every tensor a kernel reads or writes must be a contiguous tensor on
    the same CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"kernel operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def check_status(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def compile_cuda_library(name: str) -> pathlib.Path:
    """Compile `csrc/<name>.cu` into the build directory unless a library of
    the same source content (headers included) is already there."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - start
    return lib_path


def compile_all() -> None:
    """Compile every source under `csrc/` at once, one nvcc each (a build
    phase's way to pay the longest compile instead of their sum)."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for done in [pool.submit(compile_cuda_library, n) for n in names]:
            done.result()


@functools.lru_cache(maxsize=None)
def load_cuda_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` (once per source content) and load it."""
    return ctypes.CDLL(str(compile_cuda_library(name)))


def cuda_function(library: str, name: str, argtypes):
    """The C entry point `name` of `csrc/<library>.cu`, returning a CUDA
    status code."""
    fn = getattr(load_cuda_library(library), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def triton_cache_dir() -> None:
    """Point Triton's on-disk cache into the build directory (call before the
    first `import triton`)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream
