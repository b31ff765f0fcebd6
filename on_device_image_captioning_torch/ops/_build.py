"""Build, load and register the port's hand-written kernels.

CUDA sources under `csrc/` are compiled by `nvcc` into shared libraries with a
plain C interface and loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). The build directory lives inside the package and is listed in
`.gitignore`; nothing prebuilt is committed.

Every inference kernel is a `torch.library` op of the namespace `odic`
(`define_op`), defined in its own `ops/` module beside its wrapper: the op's
CPU kernel is the plain version, its CUDA kernel the launch, and a fake
implementation gives the output shapes, so that `torch.export` traces
through it. The dispatcher picks the kernel by the tensors' device; a tensor
on any other device gets its error.

Nothing is built at import time: registering an op is cheap, and
`load_cuda_library` is called by a CUDA kernel right before its first launch.
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

NAMESPACE = "odic"
LIBRARY = torch.library.Library(NAMESPACE, "DEF")
# op name -> (its CPU kernel, its CUDA kernel), as `define_op` registered them
OPS: dict = {}


def define_op(name: str, schema: str, cpu, cuda, fake):
    """Define `odic::<name><schema>` with the plain version `cpu` as its CPU
    kernel, the launch `cuda` as its CUDA kernel and `fake` (output shapes and
    dtypes only; it never queries the card) for tracing. Returns the op's
    overload, which the wrapper calls."""
    LIBRARY.define(name + schema)
    OPS[name] = (cpu, cuda)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


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
    dev = tensors[0].get_device()  # an int: cheaper than comparing torch.device objects
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"kernel operands on {t.device} and {tensors[0].device}")
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
    status code (typed once: a wrapper calls this at every launch)."""
    return _typed_function(library, name, tuple(argtypes))


@functools.lru_cache(maxsize=None)
def _typed_function(library: str, name: str, argtypes: tuple):
    fn = getattr(load_cuda_library(library), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def current_stream() -> int:
    """The raw handle of PyTorch's current stream on the current CUDA device
    (what `torch.cuda.current_stream().cuda_stream` returns, at a fraction of
    its host cost: the decode's small kernels pay it at every launch)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
