"""Incremental Dynamic-Expansion decode step (kernels K2 and B16,
`csrc/dyn_exp_step.cu`) and their plain versions.

Replaces, from `on_device_image_captioning_tpu/ops/dyn_exp_step.py`:

- `dyn_exp_step_pallas` -> `dyn_exp_step` (K2): one decode position of one
  decoder layer, with the beam reorder fused into the cache reads;
- `dyn_exp_cross_step_pallas` -> `dyn_exp_cross_step` (B16): the same step
  followed, in the same launch, by the residual add, LN2, the single-query
  cross-attention against the image's cached K/V (its Wq and out_linear
  products included) and the second residual add.

The five d x d projections (cond, key, class_a, class_b, selector) stay
`torch.matmul` in the caller (`decode/cache.py`), as they stay in XLA.

The caches are a ping-pong pair: the step reads the source set through
`reorder` and writes every position of the destination set. A kernel may not
write a cache row another row of the same launch still reads, so source and
destination must be different buffers.

Bound and design: see the header of `csrc/dyn_exp_step.cu` (bytes: the
(L, E, d) vals caches; clusters of CTAs per row: scorers that form the
forward scores once, chunks of positions that stream and contract the caches,
and the row's last cluster to finish adding their sums and running B16's
tail).
`step_plan` is the launch plan as a pure function of the shapes and the
card's SM count; the wrappers hand it to the C launcher, which checks only its
shared bytes against the card's limit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .layernorm import layernorm_reference

launches = 0  # kernel launches since the last reset (plain-version calls do not count)
cross_launches = 0  # the same for B16 (`dyn_exp_cross_step`)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's compile-time shape (kCluster, kThreads, kPerSm, kMaxD in the source)
CLUSTER = 8  # CTAs of a cluster
THREADS = 256  # threads of a CTA
CTAS_PER_SM = 2  # CTAs an SM holds (the kernel's launch bounds)
MAX_D = 512  # widest d: a lane holds its 16 values of a row in registers
MAX_SHARED = 232448  # shared bytes a CTA may use on the H100


@dataclasses.dataclass(frozen=True)
class StepPlan:
    cluster: int  # CTAs of a cluster
    chunks: int  # clusters of a row: the scorers, then one per chunk of positions
    per: int  # positions of a chunk (the last may hold fewer)
    grid: Tuple[int, int]  # (cluster x chunks, rows)
    shared_bytes: int  # dynamic shared memory of a CTA
    scorers: int  # clusters of a row that form the forward scores and the new vals rows
    regions: Tuple[int, int]  # floats of the two shared regions phases take in turn

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]

    def chunk_positions(self, chunk: int, L: int) -> range:
        """The positions cluster `chunk` of a row copies and contracts (none
        for a scorer of several: it forms forward scores and new rows)."""
        if self.chunks == 1:
            return range(L)
        if chunk < self.scorers:
            return range(0)
        first = (chunk - self.scorers) * self.per
        return range(first, min(L, first + self.per))

    def scorer_rows(self, chunk: int, E: int) -> range:
        """The rows of q_i whose forward scores and new vals rows cluster
        `chunk` of a row forms."""
        if chunk >= self.scorers:
            return range(0)
        per = _cdiv(E, self.scorers)
        return range(min(E, chunk * per), min(E, (chunk + 1) * per))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return _cdiv(n, 4) * 4


@functools.lru_cache(maxsize=1024)
def step_plan(rows: int, L: int, E: int, d: int, itemsize: int, heads: int = 0,
              S: int = 0, *, sms: int) -> StepPlan:
    """The launch of K2 (heads 0) or B16 (heads > 0, S encoder tokens) at
    these shapes on a card of `sms` SMs: clusters of CLUSTER CTAs, as many a
    row as one wave of CTAS_PER_SM x sms CTAs holds (the first one or two
    form the forward scores and the new vals rows, the others take the L
    positions in chunks; one cluster alone takes all), and the shared memory
    of a CTA. Raises ValueError where the kernel does not take the shapes: d
    must be 8 x CLUSTER to MAX_D and split into CLUSTER column slices of whole
    16-byte chunks, a row of d must be a divisor of the CTA's threads in
    16-byte chunks, E at most four a warp of a cluster, and B16 needs heads a
    multiple of CLUSTER (each CTA of a cluster takes heads / CLUSTER whole
    heads) of whole 16-byte chunks."""
    if itemsize not in (2, 4):
        raise ValueError(f"dyn_exp_step: unsupported cache item size {itemsize}")
    vec = 16 // itemsize
    if min(rows, L, E, d) <= 0 or E > 4 * THREADS // 32 * CLUSTER:
        raise ValueError(f"dyn_exp_step: unsupported shapes rows={rows} L={L} E={E} d={d}")
    if d % (CLUSTER * vec) or not 8 * CLUSTER <= d <= MAX_D or THREADS % (d // vec):
        raise ValueError(
            f"dyn_exp_step: d={d} is not {8 * CLUSTER} to {MAX_D} in {CLUSTER} column slices "
            f"of whole 16-byte chunks with a divisor of {THREADS} chunks a row")
    cs, nrg = d // CLUSTER, THREADS // (d // vec)
    # shared memory, in floats, as the kernel carves it: two regions that
    # phases take in turn, then arrays that live through the launch.
    #   region 1: a scorer's rows of q_i (E x d, cache type) while it forms
    #     the forward scores; the stream's sums by row group (2 x row groups x
    #     d); the CTA's out columns and B16's tail (y1, x2, o, q, the V and
    #     out_linear products, the products' parts, the scores).
    #   region 2: the CTA's columns of ca, cb (2 x L x cs) and of bias_i
    #     (E x cs) in the cache type while the new vals rows are formed.
    #   then k_i . cond[l] (L), k_i . embed[e] (E), the forward scores and
    #   weights (3 x E x L), the new vals rows of the CTA's columns (2 x E x
    #   cs), the CTA's sums (2 x d), block-reduction scratch, the last-cluster
    #   flag and LN2's statistics (2 x warps + 8), the backward weights of
    #   the row at pos (2 x E).
    tail, stage = 2 * cs, (2 * L * cs + E * cs) * itemsize // 4
    if heads:
        if heads % CLUSTER or d % heads or (d // heads) % vec or S <= 0:
            raise ValueError(
                f"dyn_exp_cross_step: {heads} heads of d={d} do not split over the "
                f"{CLUSTER} CTAs of a cluster in whole heads of 16-byte chunks (S={S})")
        parts = THREADS // (cs // vec)
        tail = 4 * cs + 3 * d + parts * cs + (heads // CLUSTER) * S
    regions = (_round4(max(E * d * itemsize // 4, 2 * nrg * d, tail)), _round4(stage))
    floats = (sum(regions) + L + E + 3 * E * L + 2 * E * cs + 2 * d + 2 * (THREADS // 32)
              + 8 + 2 * E)
    # one cluster a row does it all, or, where one wave holds more, the row's
    # first clusters (two where three or more fit, each on half of the rows
    # of q_i) form the forward scores and new rows and the others take the
    # positions in chunks
    want = max(1, CTAS_PER_SM * sms // (rows * CLUSTER))
    scorers = 2 if want >= 3 else 1
    per = L if want == 1 else _cdiv(L, want - scorers)
    chunks = 1 if want == 1 else scorers + _cdiv(L, per)
    plan = StepPlan(CLUSTER, chunks, per, (CLUSTER * chunks, rows), 4 * floats, scorers,
                    regions)
    if plan.shared_bytes > MAX_SHARED:
        raise ValueError(f"dyn_exp_step: {plan.shared_bytes} shared bytes at L={L}, E={E}, d={d}")
    return plan


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of the card `device` names (the wave a step plan fills)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_args(plan: StepPlan) -> Tuple[int, ...]:
    """The plan as the C launchers take it."""
    return (plan.chunks, plan.per, plan.scorers, *plan.regions, plan.shared_bytes)


def bytes_overlap(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    """Whether a tensor of `a` shares a byte with a tensor of `b` (each
    contiguous; empty ones share none): one pass over the byte ranges sorted
    by their start, holding the furthest end reached so far on each side."""
    spans = sorted([(t.data_ptr(), t.nbytes, 0) for t in a]
                   + [(t.data_ptr(), t.nbytes, 1) for t in b])
    ends = [0, 0]
    for start, size, side in spans:
        if size == 0:
            continue
        if start < ends[1 - side]:
            return True
        ends[side] = max(ends[side], start + size)
    return False


def dyn_exp_step_reference(
    pos: int,
    reorder: torch.Tensor,
    q_i: torch.Tensor,
    bias_i: torch.Tensor,
    k_i: torch.Tensor,
    ca_i: torch.Tensor,
    cb_i: torch.Tensor,
    cond_i: torch.Tensor,
    sel: torch.Tensor,
    embed: torch.Tensor,
    src: Sequence[torch.Tensor],
    eps: float = 1e-9,
):
    """Plain version. Returns (out (B, d) fp32, new caches (keys, ca, cb, cond,
    vals_a, vals_b)). The math is the XLA branch of the JAX package's
    `decode/cache.py::_dyn_exp_step`, with its products rounded through the
    cache dtype where the Pallas kernel's `_dyn_core` rounds them (a no-op in
    fp32).

    q_i, bias_i: (B, E, d); k_i, ca_i, cb_i, cond_i: (B, d); sel: (B, d) fp32;
    embed: (E, d); src caches keys/ca/cb/cond (Bs, L, d), vals (Bs, L, E, d),
    all in the cache dtype; reorder: (B,) source rows of the B output rows."""
    keys, ca, cb, cond, vals_a, vals_b = (t.index_select(0, reorder.long()) for t in src)
    b, L, E, d = vals_a.shape
    cd = keys.dtype
    f32 = torch.float32
    keys[:, pos] = k_i
    ca[:, pos] = ca_i
    cb[:, pos] = cb_i
    cond[:, pos] = cond_i
    sqrt_d = float(d) ** 0.5
    valid = torch.arange(L, device=keys.device) <= pos  # (L,)

    def rnd(x):  # round through the cache dtype
        return x.to(cd).to(f32)

    z_fw = torch.einsum("bed,bld->bel", q_i.to(f32), keys.to(f32)) / sqrt_d
    a_fw = torch.where(valid, torch.relu(z_fw), 0.0)
    b_fw = torch.where(valid, torch.relu(-z_fw), 0.0)
    a_fw = a_fw / (a_fw.sum(-1, keepdim=True) + eps)
    b_fw = b_fw / (b_fw.sum(-1, keepdim=True) + eps)
    fw_a = torch.einsum("bel,bld->bed", rnd(a_fw), ca.to(f32))
    fw_b = torch.einsum("bel,bld->bed", rnd(b_fw), cb.to(f32))
    vals_a[:, pos] = (fw_a + bias_i.to(f32)).to(cd)
    vals_b[:, pos] = (fw_b + bias_i.to(f32)).to(cd)

    kq = k_i.to(f32)
    ze = torch.einsum("ed,bd->be", embed.to(f32), kq)  # (B, E)
    zc = torch.einsum("bld,bd->bl", cond.to(f32), kq)  # (B, L)
    z_col = (zc[:, :, None] + ze[:, None, :]) / sqrt_d  # (B, L, E)
    a_bw = torch.where(valid[:, None], torch.relu(z_col), 0.0).reshape(b, L * E)
    b_bw = torch.where(valid[:, None], torch.relu(-z_col), 0.0).reshape(b, L * E)
    a_bw = a_bw / (a_bw.sum(-1, keepdim=True) + eps)
    b_bw = b_bw / (b_bw.sum(-1, keepdim=True) + eps)
    out_a = torch.einsum("bq,bqd->bd", rnd(a_bw), vals_a.reshape(b, L * E, d).to(f32))
    out_b = torch.einsum("bq,bqd->bd", rnd(b_bw), vals_b.reshape(b, L * E, d).to(f32))
    sel = sel.to(f32)
    out = sel * out_a + (1.0 - sel) * out_b
    return out, (keys, ca, cb, cond, vals_a, vals_b)


def cross_tail_reference(
    out, y, ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, *,
    heads: int, ln_eps: float, attn_fill: float, group: int = 1, compute_dtype=None,
) -> torch.Tensor:
    """y + out -> LN2 -> single-query cross-attention -> + residual, with the
    TPU kernel's rounding points (`_cross_tail`): `rd` (the compute dtype)
    after each linear and on each linear's input, `cd` (the cache dtype) for
    q and the attention weights, fp32 statistics, softmax and sums."""
    rd = compute_dtype if compute_dtype is not None else torch.float32
    cd = k_cross.dtype
    f32 = torch.float32
    y1 = y.to(f32) + out
    b, d = y1.shape
    bi, s = b // group, k_cross.shape[1]
    dk = d // heads
    x2 = layernorm_reference(y1, ln2[0], ln2[1], ln_eps)
    q = torch.matmul(x2.to(rd).to(f32), wq.to(rd).to(f32)) + bq.to(f32)
    q = q.to(rd).to(cd).to(f32).reshape(bi, group, heads, dk)
    k = k_cross.to(f32).reshape(bi, s, heads, dk)
    v = v_cross.to(f32).reshape(bi, s, heads, dk)
    scores = torch.einsum("bghd,bshd->bghs", q, k) / (dk**0.5)
    if enc_mask is not None:
        scores = torch.where(enc_mask[:, None, None, :] > 0, scores, attn_fill)
    attn = torch.softmax(scores, dim=-1).to(cd).to(f32)
    o = torch.einsum("bghs,bshd->bghd", attn, v).reshape(b, d).to(rd).to(f32)
    mo = (torch.matmul(o, wo.to(rd).to(f32)) + bo.to(f32)).to(rd).to(f32)
    return y1 + mo


def dyn_exp_cross_step_reference(
    pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
    y, ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, src, *,
    heads: int, ln_eps: float, attn_fill: float, group: int = 1, eps: float = 1e-9,
    compute_dtype=None,
):
    """Plain version of B16. Returns (y_out (B, d) fp32, new caches)."""
    out, new = dyn_exp_step_reference(
        pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, eps)
    y_out = cross_tail_reference(
        out, y, ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, heads=heads,
        ln_eps=ln_eps, attn_fill=attn_fill, group=group, compute_dtype=compute_dtype)
    return y_out, new


_STEP_ARGTYPES = [ctypes.c_void_p] * 24 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_CROSS_ARGTYPES = (
    [ctypes.c_void_p] * 34 + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
    + [ctypes.c_int] * 7 + [ctypes.c_void_p]
)


_workspace: dict = {}  # device -> (partial sums fp32, int32 counters the kernels leave at 0)


def _workspace_for(device: torch.device, rows: int, chunks: int, d: int):
    """The chunks' partial sums ((rows, chunks, 2, d) fp32) and the rows'
    arrival counters (int32 zeros, which the kernels leave at zero)."""
    floats = rows * chunks * 2 * d
    have = _workspace.get(device)
    if have is None or have[0].numel() < floats or have[1].numel() < rows:
        have = (torch.empty((max(floats, 1 << 16),), dtype=torch.float32, device=device),
                torch.zeros((max(rows, 64),), dtype=torch.int32, device=device))
        _workspace[device] = have
    return have


def _check_step_operands(name, pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel,
                         embed, src, dst) -> Tuple[int, int, int, int]:
    """What K2 and B16 ask of the step's operands. Returns (B, L, E, d). The
    kernels read the source caches through `__restrict__` pointers while they
    write the destination caches, so no destination may share a byte with any
    source; they move 16-byte chunks, so every operand starts 16-byte aligned."""
    vals_src = src[4]
    bs, L, E, d = vals_src.shape
    b = k_i.shape[0]
    cd = vals_src.dtype
    if cd not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported cache dtype {cd}")
    if not 0 <= pos < L:
        raise ValueError(f"{name}: unsupported pos={pos} / L={L}")
    shapes = [(b, E, d), (b, E, d), (b, d), (b, d), (b, d), (b, d)]
    for t, shape in zip((q_i, bias_i, k_i, ca_i, cb_i, cond_i), shapes):
        if t.shape != shape or t.dtype != cd:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype}, want {shape} {cd}")
    if embed.shape != (E, d) or embed.dtype != cd:
        raise ValueError(f"{name}: embed must be (E, d) in the cache dtype")
    if sel.shape != (b, d) or sel.dtype != torch.float32:
        raise ValueError(f"{name}: sel must be (B, d) fp32")
    if reorder.shape != (b,) or reorder.dtype != torch.int32:
        raise ValueError(f"{name}: reorder must be (B,) int32")
    want_src = [(bs, L, d)] * 4 + [(bs, L, E, d)] * 2
    want_dst = [(b, L, d)] * 4 + [(b, L, E, d)] * 2
    for s_, d_, ws, wd in zip(src, dst, want_src, want_dst):
        if s_.shape != ws or d_.shape != wd or s_.dtype != cd or d_.dtype != cd:
            raise ValueError(f"{name}: cache shapes or dtypes disagree")
    if bytes_overlap(src, dst):
        raise ValueError(f"{name}: dst caches alias the src caches (their bytes overlap)")
    if any(t.data_ptr() % 16 for t in (*src, *dst, q_i, bias_i, k_i, ca_i, cb_i, cond_i, embed)):
        raise ValueError(f"{name}: caches and step operands must start 16-byte aligned")
    return b, L, E, d


_DST = ", ".join(f"Tensor({tag}!) dst_{name}" for tag, name in zip(
    "abcdef", ("keys", "ca", "cb", "cond", "vals_a", "vals_b")))
_STEP_OPERANDS = ("int pos, Tensor reorder, Tensor q_i, Tensor bias_i, Tensor k_i, Tensor ca_i, "
                  "Tensor cb_i, Tensor cond_i, Tensor sel, Tensor embed")


def _dyn_exp_step_plain(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src,
                        *rest):
    *dst, eps = rest
    out, new = dyn_exp_step_reference(
        pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, eps)
    for d_, n_ in zip(dst, new):
        d_.copy_(n_)
    return out


def _dyn_exp_step_cuda(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src,
                       *rest) -> torch.Tensor:
    """Kernel K2 on CUDA tensors: the CUDA kernel of `odic::dyn_exp_step`."""
    global launches
    *dst, eps = rest
    b, L, E, d = _check_step_operands(
        "dyn_exp_step", pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
        src, dst)
    cd = src[4].dtype
    plan = step_plan(b, L, E, d, src[4].element_size(), sms=sm_count(k_i.device))
    _build.check_cuda_tensors(
        reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, *src, *dst
    )
    out = torch.empty((b, d), dtype=torch.float32, device=k_i.device)
    part, counter = _workspace_for(k_i.device, b, plan.chunks, d)
    fn = _build.cuda_function("dyn_exp_step", "dyn_exp_step_launch", _STEP_ARGTYPES)
    status = fn(
        reorder.data_ptr(), q_i.data_ptr(), bias_i.data_ptr(), k_i.data_ptr(),
        ca_i.data_ptr(), cb_i.data_ptr(), cond_i.data_ptr(), sel.data_ptr(),
        embed.data_ptr(), *(t.data_ptr() for t in src),
        *(t.data_ptr() for t in dst), out.data_ptr(), part.data_ptr(), counter.data_ptr(),
        b, L, E, d, int(pos), float(d) ** 0.5, float(eps), *_plan_args(plan), _DTYPE_CODE[cd],
        _build.current_stream(),
    )
    _build.check_status(status, "dyn_exp_step")
    launches += 1
    return out


_step_op = _build.define_op(
    "dyn_exp_step", f"({_STEP_OPERANDS}, Tensor[] src, {_DST}, float eps) -> Tensor",
    _dyn_exp_step_plain, _dyn_exp_step_cuda,
    lambda pos, reorder, q_i, *rest: q_i.new_empty((q_i.shape[0], q_i.shape[2]),
                                                    dtype=torch.float32))


def dyn_exp_step(
    pos: int,
    reorder: torch.Tensor,
    q_i: torch.Tensor,
    bias_i: torch.Tensor,
    k_i: torch.Tensor,
    ca_i: torch.Tensor,
    cb_i: torch.Tensor,
    cond_i: torch.Tensor,
    sel: torch.Tensor,
    embed: torch.Tensor,
    src: Sequence[torch.Tensor],
    dst: Sequence[torch.Tensor],
    eps: float = 1e-9,
) -> torch.Tensor:
    """One decode step: writes all six dst caches and returns out (B, d) fp32.
    `odic::dyn_exp_step` (the dst caches are its mutated arguments): the
    plain version on CPU tensors, kernel K2 on CUDA tensors."""
    return _step_op(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, list(src),
                    *dst, eps)


def _cross_step_plain(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
                      y, ln2_w, ln2_b, wq, bq, wo, bo, k_cross, v_cross, enc_mask, src, *rest):
    *dst, heads, ln_eps, attn_fill, group, eps, compute_dtype = rest
    y_out, new = dyn_exp_cross_step_reference(
        pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
        y, (ln2_w, ln2_b), wq, bq, wo, bo, k_cross, v_cross, enc_mask, src, heads=heads,
        ln_eps=ln_eps, attn_fill=attn_fill, group=group, eps=eps, compute_dtype=compute_dtype)
    for d_, n_ in zip(dst, new):
        d_.copy_(n_)
    return y_out


def _cross_step_cuda(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
                     y, ln2_w, ln2_b, wq, bq, wo, bo, k_cross, v_cross, enc_mask, src, *rest
                     ) -> torch.Tensor:
    """Kernel B16 on CUDA tensors: the CUDA kernel of `odic::dyn_exp_cross_step`."""
    global cross_launches
    *dst, heads, ln_eps, attn_fill, group, eps, compute_dtype = rest
    ln2 = (ln2_w, ln2_b)
    name = "dyn_exp_cross_step"
    b, L, E, d = _check_step_operands(
        name, pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, dst)
    cd = src[4].dtype
    rd = compute_dtype if compute_dtype is not None else torch.float32
    if rd != cd:
        raise ValueError(f"{name}: B16 takes compute dtype == cache dtype, got {rd} / {cd}")
    if group < 1 or b % group:
        raise ValueError(f"{name}: {b} rows do not split into groups of {group}")
    s_enc = k_cross.shape[1]
    plan = step_plan(b, L, E, d, src[4].element_size(), heads, s_enc, sms=sm_count(k_i.device))
    if k_cross.shape != (b // group, s_enc, d) or v_cross.shape != k_cross.shape or (
            k_cross.dtype != cd or v_cross.dtype != cd):
        raise ValueError(f"{name}: k_cross, v_cross must be (B / group, S, d) in the cache dtype")
    for w_ in (wq, wo):
        if w_.shape != (d, d) or w_.dtype != cd:
            raise ValueError(f"{name}: wq, wo must be (d, d) as (in, out) in the cache dtype")
    for v_ in (y, *ln2, bq, bo):
        if v_.dtype != torch.float32 or v_.shape[-1] != d:
            raise ValueError(f"{name}: y, ln2, bq, bo must be fp32 of width d")
    if y.shape != (b, d):
        raise ValueError(f"{name}: y must be (B, d)")
    if enc_mask is not None and (
            enc_mask.dtype != torch.float32 or enc_mask.shape != (b // group, s_enc)):
        raise ValueError(f"{name}: enc_mask must be fp32 (B / group, S)")
    operands = [reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, *src, *dst,
                y, *ln2, wq, bq, wo, bo, k_cross, v_cross]
    if enc_mask is not None:
        operands.append(enc_mask)
    _build.check_cuda_tensors(*operands)
    if any(t.data_ptr() % 16 for t in (wq, wo, k_cross, v_cross, sel, y, *ln2, bq, bo)):
        raise ValueError(f"{name}: wq, wo, k_cross, v_cross, sel, y, ln2, bq, bo must start "
                         "16-byte aligned")
    y_out = torch.empty((b, d), dtype=torch.float32, device=k_i.device)
    part, counter = _workspace_for(k_i.device, b, plan.chunks, d)
    fn = _build.cuda_function("dyn_exp_step", "dyn_exp_cross_step_launch", _CROSS_ARGTYPES)
    status = fn(
        reorder.data_ptr(), q_i.data_ptr(), bias_i.data_ptr(), k_i.data_ptr(),
        ca_i.data_ptr(), cb_i.data_ptr(), cond_i.data_ptr(), sel.data_ptr(),
        embed.data_ptr(), *(t.data_ptr() for t in src),
        *(t.data_ptr() for t in dst), y.data_ptr(),
        ln2[0].data_ptr(), ln2[1].data_ptr(), wq.data_ptr(), bq.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), k_cross.data_ptr(), v_cross.data_ptr(),
        None if enc_mask is None else enc_mask.data_ptr(), y_out.data_ptr(),
        part.data_ptr(), counter.data_ptr(), b, L, E, d, int(pos), s_enc, heads, group,
        float(d) ** 0.5, float(eps), float(ln_eps), float(attn_fill), *_plan_args(plan),
        _DTYPE_CODE[cd], _build.current_stream(),
    )
    _build.check_status(status, name)
    cross_launches += 1
    return y_out


_cross_op = _build.define_op(
    "dyn_exp_cross_step",
    f"({_STEP_OPERANDS}, Tensor y, Tensor ln2_w, Tensor ln2_b, Tensor wq, Tensor bq, "
    f"Tensor wo, Tensor bo, Tensor k_cross, Tensor v_cross, Tensor? enc_mask, Tensor[] src, "
    f"{_DST}, int heads, float ln_eps, float attn_fill, int group, float eps, "
    f"ScalarType? compute_dtype) -> Tensor",
    _cross_step_plain, _cross_step_cuda,
    lambda pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, y, *rest: (
        y.new_empty(y.shape)))


def dyn_exp_cross_step(
    pos: int,
    reorder: torch.Tensor,
    q_i: torch.Tensor,
    bias_i: torch.Tensor,
    k_i: torch.Tensor,
    ca_i: torch.Tensor,
    cb_i: torch.Tensor,
    cond_i: torch.Tensor,
    sel: torch.Tensor,
    embed: torch.Tensor,
    y: torch.Tensor,
    ln2: Tuple[torch.Tensor, torch.Tensor],
    wq: torch.Tensor,
    bq: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    k_cross: torch.Tensor,
    v_cross: torch.Tensor,
    enc_mask: Optional[torch.Tensor],
    src: Sequence[torch.Tensor],
    dst: Sequence[torch.Tensor],
    *,
    heads: int,
    ln_eps: float,
    attn_fill: float,
    group: int = 1,
    eps: float = 1e-9,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One decode step of a decoder layer up to and including its
    cross-attention: writes all six dst caches and returns the residual stream
    y + dyn + cross (B, d) fp32.

    y (B, d) fp32 is the stream before the dynamic-expansion add; ln2 =
    (scale, bias) fp32; wq, wo (d, d) as (in, out) in the compute dtype, bq,
    bo fp32; k_cross, v_cross (B / group, S, d) in the cache dtype; enc_mask
    (B / group, S) fp32, > 0 where the encoder token is real, or None. Row i
    reads image row i // group. `odic::dyn_exp_cross_step` (the dst caches
    are its mutated arguments): the plain version on CPU tensors, kernel B16
    on CUDA tensors, which is built for compute dtype == cache dtype."""
    return _cross_op(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
                     y, *ln2, wq, bq, wo, bo, k_cross, v_cross, enc_mask, list(src), *dst,
                     heads, ln_eps, attn_fill, group, eps, compute_dtype)
