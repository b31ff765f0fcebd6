"""Swin window-attention core (kernel K1, `csrc/window_attention.cu`) and its
plain version.

Replaces `on_device_image_captioning_tpu/ops/window_attention.py::
window_attention_pallas` and, on the same math, `ops/swin_block_fused.py::
attention_core_fused`: one kernel on the flat qkv layout serves both. The qkv
and proj GEMMs stay `torch.matmul`, as they stay plain GEMMs in JAX.

Bound and design: see the header of `csrc/window_attention.cuh` (bf16 windows
of 144 tokens on the tensor cores with the scores in registers, everything
else fp32 CUDA-core math; a CTA a mask row, a run of heads and a share of the
images, so that bias and mask are read once for the windows that share
them). `attention_plan` picks that split from the shapes and the card's SM
count; the attention half (B4, B10a) launches the same core with it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from .linear_plan import sm_count

launches = 0  # kernel launches since the last reset (plain-version calls do not count)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 32  # Swin-L's dk at every stage; the only width K1 is built for
# csrc/window_attention.cuh: the tensor-core kernel's window and threads (a
# warp a strip of 16 query rows), the CUDA-core kernel's largest window and
# its rows of K and V in shared memory (dk + 4 floats)
MMA_TOKENS = 144
MMA_THREADS = 32 * (MMA_TOKENS // 16)
CORE_MAX_TOKENS = 192
CORE_LD = HEAD_DIM + 4
# the shared memory a CTA may take on the H100 (232,448 bytes) and its
# registers; the kernels' registers a thread, as `nvcc -Xptxas -v` reports
# them for sm_90a (the CUDA-core kernel: its instance for N <= 144, and the
# one for 144 < N <= 192)
SMEM_LIMIT = 232448
SM_REGISTERS = 65536
REGISTERS = {"mma": 168, "cores": 168, "cores_wide": 168}
# the instances `kernel_resources` reads (csrc/window_attention.cuh::
# attention_attributes), in its order: (route, dtype)
INSTANCES = (("mma", torch.bfloat16), ("cores", torch.float32), ("cores_wide", torch.float32),
             ("cores", torch.bfloat16), ("cores_wide", torch.bfloat16))
# the local memory a thread of each instance, in INSTANCES' order, with K1's
# rounding (False) and the fused one (True): ptxas's stack frame for sm_90a,
# which is where the CUDA-core instances spill (the tensor-core kernel does
# not). The card test `test_attention_core_resources_match_ptxas` holds these
# and REGISTERS to the loaded kernels.
LOCAL_BYTES = {False: (0, 48, 112, 48, 120), True: (0, 32, 96, 24, 128)}
# The plan's cost of a CTA, in tenths of one (window, head) of work on its
# route: a new head's bias (the tensor-core kernel's strip fetched behind
# the unit before and the mask added to it; the CUDA-core kernel's bias +
# mask summed into shared memory) and the CTA's mask row, which the first
# unit waits for. One CTA an SM on both routes. Calibrated on the H100
# (`cli/attention_turns.py --splits`): with these the plan takes the fastest
# split measured at each of the encode's shapes.
UNIT_COST = 10
HEAD_COST = {"mma": 3, "cores": 2}
MASK_COST = {"mma": 5, "cores": 0}


def window_attention_reference(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    heads: int,
    scale: float,
) -> torch.Tensor:
    """qkv (BW, N, 3C) -> (BW, N, C). bias (H, N, N) fp32; mask (nW, N, N)
    fp32 additive or None, picked by window index w % nW."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    dk = c // heads
    q, k, v = qkv.reshape(bw, n, 3, heads, dk).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n) + mask.float()[None, :, None])
        s = s.reshape(bw, heads, n, n)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # (BW, H, N, dk)
    return out.transpose(1, 2).reshape(bw, n, c)


def _core_bm_ld(n: int) -> int:
    """fp32 row stride of the CUDA-core kernel's bias + mask (2 mod 16)."""
    return n + (18 - n % 16) % 16


def _core_threads(n: int) -> int:
    """The CUDA-core kernel's threads: a quad of lanes every two rows."""
    return (4 * ((n + 1) // 2) + 31) // 32 * 32


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    route: str  # "mma" (bf16, N = 144: the tensor cores) or "cores" (the CUDA cores)
    groups: int  # windows of one mask row form a group: nW with a mask, else 1
    heads_per_cta: int  # consecutive heads a CTA takes
    splits: int  # shares of a group's images, a CTA each
    ctas: int
    threads: int
    smem_bytes: int
    registers: int  # a thread's, the kernel's instance

    def units_of(self, cta: int, bw: int, heads: int) -> List[Tuple[int, int]]:
        """The (window, head) units CTA `cta` takes, in its order: group
        cta % groups, then the run of heads, then the share of images (the
        kernel's `attn_units`), heads outer."""
        p, rest = cta % self.groups, cta // self.groups
        runs = -(-heads // self.heads_per_cta)
        run, share = rest % runs, rest // runs
        h0 = run * self.heads_per_cta
        images = bw // self.groups
        b0, b1 = share * images // self.splits, (share + 1) * images // self.splits
        return [(p + self.groups * b, h) for h in range(h0, min(heads, h0 + self.heads_per_cta))
                for b in range(b0, b1)]


@functools.lru_cache(maxsize=1024)
def attention_plan(bw: int, nW: int, heads: int, masked: bool, dtype: torch.dtype, sms: int,
                   n: int = MMA_TOKENS) -> AttentionPlan:
    """K1's launch for `bw` windows of `n` tokens and `heads` heads (nW mask
    rows where `masked`) in `dtype` on a card of `sms` SMs. The windows that
    share a mask row (all of them without a mask) form a group; a CTA takes a
    group, a run of heads that divides `heads` and one of `splits` shares of
    the group's images, so it reads each of its heads' bias and its mask row
    once. Of those splits the one whose waves of CTAs (one an SM) cost the
    least, where a CTA costs its units of work plus a load for each head's
    bias and for its mask row; on a tie the fewer CTAs, then the shorter run."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"window_attention: unsupported dtype {dtype}")
    if not 1 <= n <= CORE_MAX_TOKENS:
        raise ValueError(f"window_attention: window of {n} tokens exceeds shared memory "
                         f"(at most {CORE_MAX_TOKENS})")
    groups = nW if masked else 1
    if bw < 1 or heads < 1 or sms < 1 or groups < 1 or bw % groups:
        raise ValueError(f"window_attention: no launch for bw={bw} nW={nW} heads={heads} "
                         f"sms={sms}")
    route = "mma" if dtype == torch.bfloat16 and n == MMA_TOKENS else "cores"
    images = bw // groups
    best = None
    for run in (g for g in range(1, heads + 1) if heads % g == 0):
        for splits in range(1, images + 1):
            ctas = groups * (heads // run) * splits
            per_cta = (MASK_COST[route] * masked
                       + run * (HEAD_COST[route] + UNIT_COST * -(-images // splits)))
            key = (-(-ctas // sms) * per_cta, ctas, run)
            if best is None or key < best[0]:
                best = (key, run, splits, ctas)
    _, run, splits, ctas = best
    if route == "mma":
        threads = MMA_THREADS
        # two q | k | v stages, the head's bias and the mask row (fp32 rows of N + 8)
        smem = 2 * 3 * MMA_TOKENS * HEAD_DIM * 2 + 128 + (1 + masked) * (
            MMA_TOKENS * (MMA_TOKENS + 8) * 4)
        registers = REGISTERS["mma"]
    else:
        threads = _core_threads(n)
        smem = (2 * n * CORE_LD + n * _core_bm_ld(n)) * 4
        registers = REGISTERS["cores" if n <= MMA_TOKENS else "cores_wide"]
    return AttentionPlan(route, groups, run, splits, ctas, threads, smem, registers)


@functools.cache
def _launcher():
    return _build.cuda_function("window_attention", "window_attention_launch", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 5, ctypes.c_float, *[ctypes.c_int] * 3, ctypes.c_void_p,
    ))


def kernel_resources(fused: bool = False) -> List[Tuple[str, torch.dtype, int, int]]:
    """(route, dtype, registers, local bytes) a thread of each instance of
    the attention core in INSTANCES, as the module loaded on the card has
    them (`cudaFuncGetAttributes`): K1's library (window_attention_pallas's
    rounding) or, with `fused`, the attention half's (B4 and B10a)."""
    lib, name = (("swin_attn_half", "swin_attn_half_core_attributes") if fused else
                 ("window_attention", "window_attention_attributes"))
    fn = _build.cuda_function(lib, name, (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))
    out = []
    for which, (route, dtype) in enumerate(INSTANCES):
        registers, local = ctypes.c_int(), ctypes.c_int()
        status = fn(which, ctypes.byref(registers), ctypes.byref(local))
        if status != 0:  # a query, not a launch
            raise RuntimeError(f"{name}: CUDA error {status}")
        out.append((route, dtype, registers.value, local.value))
    return out


def check_aligned(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """The attention core reads q, k, v, bias and mask in 16-byte chunks."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: qkv, bias and mask must be 16-byte aligned")


def _window_attention_cuda(qkv, bias, mask, heads: int, scale: float,
                           split: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K1 on CUDA tensors: the CUDA kernel of `odic::window_attention`, in
    `attention_plan`'s split (heads a CTA, shares of the images), or in the
    one given (`cli/attention_turns.py --splits` times them all)."""
    global launches
    bw, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c != heads * HEAD_DIM:
        raise ValueError(f"window_attention: K1 takes head width {HEAD_DIM}, got "
                         f"qkv width {c3} / heads {heads}")
    if qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"window_attention: unsupported dtype {qkv.dtype}")
    if bias.dtype != torch.float32 or bias.shape != (heads, n, n):
        raise ValueError("window_attention: bias must be fp32 (H, N, N)")
    operands = [qkv, bias]
    num_windows = 1
    if mask is not None:
        num_windows = mask.shape[0]
        if mask.dtype != torch.float32 or mask.shape[1:] != (n, n) or bw % num_windows:
            raise ValueError("window_attention: mask must be fp32 (nW, N, N), nW | BW")
        operands.append(mask)
    _build.check_cuda_tensors(*operands)
    check_aligned("window_attention", *operands)
    out = torch.empty((bw, n, c), dtype=qkv.dtype, device=qkv.device)
    if bw == 0:
        return out
    if split is None:
        plan = attention_plan(bw, num_windows, heads, mask is not None, qkv.dtype,
                              sm_count(qkv.device), n)
        split = (plan.heads_per_cta, plan.splits)
    heads_per_cta, splits = split
    if heads_per_cta < 1 or not 1 <= splits <= (bw // num_windows if mask is not None else bw):
        raise ValueError(f"window_attention: no split of {heads_per_cta} heads a CTA in "
                         f"{splits} shares")
    status = _launcher()(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        bw, n, c, heads, num_windows, float(scale), heads_per_cta, splits,
        _DTYPE_CODE[qkv.dtype], _build.current_stream(),
    )
    _build.check_status(status, "window_attention")
    launches += 1
    return out


_op = _build.define_op(
    "window_attention",
    "(Tensor qkv, Tensor bias, Tensor? mask, int heads, float scale) -> Tensor",
    window_attention_reference, _window_attention_cuda,
    lambda qkv, bias, mask, heads, scale: qkv.new_empty(
        (qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3)),
)


def window_attention(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    heads: int,
    scale: float,
) -> torch.Tensor:
    """Window attention over the flat qkv layout: `odic::window_attention`
    (the plain version on CPU tensors, kernel K1 on CUDA tensors)."""
    return _op(qkv, bias, mask, heads, scale)
