"""Main-path cases for holding each hand-written kernel against its plain
PyTorch version on CUDA tensors, with the tolerance of every check.

The shapes are the ones the main path gives each kernel: Swin-L/384 windows
at B=2 (for the window-resident path's kernels too: every stage width, masked
and unmasked, with and without the shift transition), the d512 decoder at
B·beam = 24 rows (serve), 5 (latency), 1, 12 and 40 (the edges and the
middle branch of the decode step's launch plan), with its cross-attention over 144 encoder tokens for the
fused step, V = 10000 log-prob rows, and every LayerNorm width.
`chip_smoke.py` checks and times these cases, and
`tests/test_torch_kernels.py` checks them under pytest; both read them from
here so the two cannot drift apart.

Each case calls the wrappers (`window_attention`, `swin_attn_half`, ...),
exactly as the main path does, so the wrappers' routing is checked along with
the kernels. Each case also states the work of its call, computed from its
shapes: the bytes the function must move (every input read once, every output
written once) and its floating-point operations, from which `chip_smoke.py`
computes the least time the card could take.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

import torch

from ..models.swin import shift_attn_mask
from . import dyn_exp_step as k2
from . import layernorm as k4
from . import quant_matmul as qm
from . import stage_boundary as sb
from . import swin_block_fused as sbf
from . import topk as k3
from . import window_attention as k1

VOCAB = 10000
# (atol, rtol) per dtype. fp32: kernel and plain version differ only in
# summation order. bf16: results are rounded to bf16 on both sides, so an fp32
# difference at a rounding boundary shows as one bf16 ulp (2^-8 relative).
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# top-k returns copies of its inputs and their indices: both must be equal
EXACT = (0.0, 0.0)

# (part, got, want, (atol, rtol))
Check = Tuple[str, torch.Tensor, torch.Tensor, Tuple[float, float]]


@dataclasses.dataclass
class Case:
    kernel: str  # a key of CASES
    label: str
    run_kernel: Callable[[], object]  # the wrapper on CUDA tensors: launches
    run_plain: Callable[[], object]  # the plain version on the same tensors
    checks: Callable[[object, object], List[Check]]
    args: tuple = ()  # the wrapper's arguments (a library yardstick reads them)
    nbytes: int = 0  # bytes the function must move: inputs once, outputs once
    flops: int = 0  # floating-point operations of the function on these inputs
    matmul: bool = False  # the operations are matrix products of the inputs' dtype
    int8: bool = False  # the operations are int8 matrix products
    # the calls to time where run_kernel / run_plain also return what only the
    # checks read (None: time run_kernel and run_plain themselves)
    time_kernel: Optional[Callable[[], object]] = None
    time_plain: Optional[Callable[[], object]] = None
    # the kernel's own last launch alone, on inputs its wrapper prepared
    # beforehand (B12: the product on the already-quantized x), or None
    time_alone: Optional[Callable[[], object]] = None

    def check(self) -> List[Check]:
        """Run the kernel and the plain version once each; the pairs to hold
        against each other."""
        return self.checks(self.run_kernel(), self.run_plain())


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _randn(shape, g, dev, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _one(tol):
    return lambda got, want: [("out", got, want, tol)]


# Swin-L/384 stages: (C, heads, token-grid side); windows of 12 x 12, shift 6
STAGES = [(192, 6, 96), (384, 12, 48), (768, 24, 24), (1536, 48, 12)]
WINDOW, SHIFT, N_TOKENS = 12, 6, 144


def window_attention_cases(dev) -> Iterator[Case]:
    """The four Swin-L/384 stages at B=2, with and without the shift mask,
    fp32 and bf16. Stage 3 (one window) has no shift on the main path; a
    random 0/-100 mask stands in so the masked branch runs there too. Then
    the tensor-parallel serve shape (MAIN_PATH_TP): stage 0 of a b8 batch
    on one rank of a model group of 2, its 3 of the 6 heads."""

    def case(stage, b, heads, dt, m, label):
        c, _, res = STAGES[stage]
        nw = (res // 12) ** 2
        g = torch.Generator().manual_seed(100 + stage + 1000 * (heads != STAGES[stage][1]))
        width = heads * k1.HEAD_DIM
        qkv = _randn((b * nw, 144, 3 * width), g, dev, dtype=dt)
        bias = _randn((heads, 144, 144), g, dev, scale=0.5)
        if m:
            if nw > 1:
                mask = torch.from_numpy(shift_attn_mask(res, 12, 6)).to(dev)
            else:
                mask = torch.where(torch.rand((1, 144, 144), generator=g) > 0.7, -100.0, 0.0)
                mask = mask.to(dev)
        else:
            mask = None
        a = (qkv, bias, mask, heads, k1.HEAD_DIM**-0.5)
        return Case(
            "window_attention",
            f"{label}qkv{tuple(qkv.shape)} H{heads} "
            f"{'mask' if m else 'nomask'} {_dtype_name(dt)}",
            lambda a=a: k1.window_attention(*a),
            lambda a=a: k1.window_attention_reference(*a),
            _one(TOL[dt]), args=a,
            nbytes=_nbytes(qkv, bias, mask) + qkv.numel() // 3 * qkv.element_size(),
            flops=4 * qkv.shape[0] * 144 * 144 * width, matmul=True,
        )

    for dt in (torch.float32, torch.bfloat16):
        for stage, (_, heads, _) in enumerate(STAGES):
            for m in (True, False):
                yield case(stage, 2, heads, dt, m, f"stage{stage} ")
    for b, stage, n_model in MAIN_PATH_TP:
        for dt in (torch.float32, torch.bfloat16):
            yield case(stage, b, STAGES[stage][1] // n_model, dt, True,
                       f"b{b} stage{stage} tp{n_model} ")


# (batch, stage, model ranks) of the tensor-parallel serve shapes with cases
# of their own: run "parallel_eval"'s "pallas" backbone at b8 on one rank of a
# model group of 2 (stage 0's 6 heads, 3 a rank)
MAIN_PATH_TP = [(8, 0, 2)]


# decode-step shapes: (rows, images, L, positions, seed). 24 rows are b8 x
# beam 3 (serve), 5 rows b1 x beam 5 (latency), 40 rows b8 x beam 5 and 1
# row the edges of the step's launch plan, 12 rows (b4 x beam 3) its middle
# branch (one scorer cluster and one chunk of every position); every reorder
# with two or more rows continues one source row twice (beam duplication).
STEP_SHAPES = [
    (24, 8, 20, (0, 7, 19), None), (24, 8, 74, (0, 7, 73), None),
    (5, 1, 74, (0, 7, 36, 73), None), (1, 1, 74, (0, 73), 2101), (40, 8, 20, (0, 7, 19), 2140),
    (12, 4, 20, (7,), 2112), (12, 4, 74, (0, 73), 2174),
]
# the SCST sampler's (train/train_step.py::make_scst_fused_step): 4 images x 5
# samples, fp32 caches of 20 + 1 positions (the sampler's caches are fp32
# whatever the model's compute dtype)
SCST_STEP = (20, 4, 21, (0, 7, 20), 2221)


def _step_operands(b, L, E, d, dt, g, dev, first):
    """Source caches, a reorder that continues row `first` at output row 0
    and one source row twice, and the step's row operands."""
    src = [_randn((b, L, d), g, dev, dtype=dt) for _ in range(4)]
    src += [_randn((b, L, E, d), g, dev, dtype=dt) for _ in range(2)]
    reorder = torch.randint(0, b, (b,), generator=g, dtype=torch.int32)
    reorder[0] = first % b  # non-identity for sure where b > 1
    if b > 1:
        reorder[-1] = reorder[0]  # a duplicated row for sure
    reorder = reorder.to(dev)
    q_i = _randn((b, E, d), g, dev, dtype=dt)
    bias_i = _randn((b, E, d), g, dev, dtype=dt)
    rows = [_randn((b, d), g, dev, dtype=dt) for _ in range(4)]
    sel = torch.sigmoid(_randn((b, d), g, dev))
    embed = _randn((E, d), g, dev, dtype=dt)
    return src, reorder, q_i, bias_i, rows, sel, embed


def _step_checks(first_name):
    def checks(got, want, tol):
        (out, new), (want_out, want_new) = got, want
        pairs = [(first_name, out, want_out, tol)]
        names = ("keys", "ca", "cb", "cond", "vals_a", "vals_b")
        return pairs + [(n, g_, w_, tol) for n, g_, w_ in zip(names, new, want_new)]
    return checks


def dyn_exp_step_cases(dev) -> Iterator[Case]:
    """K2 at the STEP_SHAPES (E=16, d=512), fp32 and bf16 caches, and at the
    SCST sampler's own shape (SCST_STEP). Checks the output and all six
    destination caches."""
    E, d = 16, 512
    checks = _step_checks("out")
    shapes = [(dt, "", shape) for dt in (torch.float32, torch.bfloat16) for shape in STEP_SHAPES]
    shapes.append((torch.float32, "b4 sampling ", SCST_STEP))
    for dt, prefix, (b, _, L, positions, seed) in shapes:
        tol = TOL[dt]
        g = torch.Generator().manual_seed(200 + L if seed is None else seed)
        src, reorder, q_i, bias_i, rows, sel, embed = _step_operands(
            b, L, E, d, dt, g, dev, first=5)
        dst = [torch.empty_like(t) for t in src]
        for pos in positions:
            a = (pos, reorder, q_i, bias_i, *rows, sel, embed, src)

            def run_kernel(a=a, dst=dst):
                return k2.dyn_exp_step(*a, dst), dst

            yield Case(
                "dyn_exp_step", f"{prefix}B{b} L{L} pos{pos} {_dtype_name(dt)}",
                run_kernel, lambda a=a: k2.dyn_exp_step_reference(*a),
                lambda got, want, tol=tol: checks(got, want, tol), args=a,
                # the step returns every position of the six caches
                nbytes=2 * _nbytes(*src) + _nbytes(reorder, q_i, bias_i, *rows, sel, embed)
                + b * d * 4,
                flops=10 * b * (pos + 1) * E * d, matmul=True,
            )


def dyn_exp_cross_step_cases(dev) -> Iterator[Case]:
    """B16 at the STEP_SHAPES (images x beams rows), S=144 encoder tokens,
    d=512, 8 heads, E=16, a pad mask with 0 and 16 pads, fp32 and bf16.
    Checks the output row and all six destination caches."""
    E, d, heads, S = 16, 512, 8, 144
    checks = _step_checks("y_out")
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        for b, images, L, positions, seed in STEP_SHAPES:
            group = b // images
            g = torch.Generator().manual_seed(1000 + 10 * L + b if seed is None else seed + 1)
            src, reorder, q_i, bias_i, rows, sel, embed = _step_operands(
                b, L, E, d, dt, g, dev, first=4)
            y = _randn((b, d), g, dev)
            ln2 = _norm(d, g, dev)
            (wq, bq), (wo, bo) = _linear(d, d, g, dev, dt), _linear(d, d, g, dev, dt)
            kc = _randn((images, S, d), g, dev, dtype=dt)
            vc = _randn((images, S, d), g, dev, dtype=dt)
            pads = torch.tensor([0, 16] * 4)[:images]
            mask = (torch.arange(S)[None, :] < (S - pads)[:, None]).float().to(dev)
            dst = [torch.empty_like(t) for t in src]
            kw = dict(heads=heads, ln_eps=1e-5, attn_fill=-1e4, group=group, eps=1e-9,
                      compute_dtype=dt)
            for pos in positions:
                a = (pos, reorder, q_i, bias_i, *rows, sel, embed, y, ln2, wq, bq, wo, bo,
                     kc, vc, mask, src)

                def run_kernel(a=a, dst=dst, kw=kw):
                    return k2.dyn_exp_cross_step(*a, dst, **kw), dst

                yield Case(
                    "dyn_exp_cross_step", f"B{b} L{L} pos{pos} {_dtype_name(dt)}",
                    run_kernel, lambda a=a, kw=kw: k2.dyn_exp_cross_step_reference(*a, **kw),
                    lambda got, want, tol=tol: checks(got, want, tol), args=a,
                    # K2's bytes plus y, LN2, Wq, Wo, the images' K and V and the mask
                    nbytes=2 * _nbytes(*src) + _nbytes(reorder, q_i, bias_i, *rows, sel, embed)
                    + _nbytes(y, *ln2, wq, bq, wo, bo, kc, vc, mask) + b * d * 4,
                    flops=10 * b * (pos + 1) * E * d + b * (4 * d * d + 4 * S * d), matmul=True,
                )


def topk_cases(dev) -> Iterator[Case]:
    """(24, V) log-prob rows with planted exact ties, a row of dense exact
    ties, a row with fewer than k finite values and a NaN row; k up to 8,
    fp32 and bf16, plus the 8-row SOS step. Values and indices exactly."""
    g = torch.Generator().manual_seed(300)
    x = torch.log_softmax(torch.randn((24, VOCAB), generator=g) * 3.0, dim=-1)
    x[:, 100] = x[:, 7]
    x[:, 200] = x.max(dim=1).values
    x[:, 900] = x[:, 200]
    levels = torch.randn(4, generator=g)
    x[3] = levels[torch.randint(0, 4, (VOCAB,), generator=g)]  # dense exact ties
    x[5] = -float("inf")
    x[5, 10], x[5, 4000] = -1.0, -2.0  # fewer than k finite values
    x[9, 3000] = float("nan")  # a NaN row
    x = x.to(dev)
    xb = x.to(torch.bfloat16)
    runs = [(f"R24 V{VOCAB} k{k} float32", x, k) for k in (1, 3, 5, 8)]
    runs += [(f"R24 V{VOCAB} k{k} bfloat16", xb, k) for k in (3, 8)]
    runs.append((f"R8 V{VOCAB} k3 float32 (SOS step)", x[:8].contiguous(), 3))
    # rows enough for clusters of 4 (b8 x beam 5) and of one CTA
    runs.append((f"R40 V{VOCAB} k5 float32", torch.cat([x, x[:16]]).to(dev), 5))
    runs.append((f"R160 V{VOCAB} k8 float32", torch.cat([x] * 6 + [x[:16]]).to(dev), 8))
    # the main path's own: the b1 / beam 5 beam step, and the sampling path's
    # Gumbel-noised rows (decode/beam_search.py::_candidates)
    g = torch.Generator().manual_seed(310)
    lat = torch.log_softmax(torch.randn((5, VOCAB), generator=g) * 3.0, dim=-1)
    runs.append((f"b1 decode R5 V{VOCAB} k5 float32", lat.to(dev), 5))
    logp = torch.log_softmax(torch.randn((24, VOCAB), generator=g) * 3.0, dim=-1)
    u = torch.rand((24, VOCAB), generator=g).clamp_min(torch.finfo(torch.float32).tiny)
    runs.append((f"b8 sampling R24 V{VOCAB} k3 float32 Gumbel",
                 (logp - torch.log(-torch.log(u))).to(dev), 3))

    def checks(got, want):
        (vals, idx), (want_v, want_i) = got, want
        return [("indices", idx, want_i, EXACT), ("values", vals, want_v, EXACT)]

    for label, xt, k in runs:
        yield Case(
            "topk", label,
            lambda xt=xt, k=k: k3.topk(xt, k),
            lambda xt=xt, k=k: k3.topk_reference(xt, k),
            checks, args=(xt, k),
            nbytes=_nbytes(xt) + xt.shape[0] * k * (xt.element_size() + 4),
            flops=xt.numel() * k,  # one comparison per element and pass
        )


def _layernorm_case(label, x, w, bias) -> Case:
    rows, c = x.shape
    dt = x.dtype
    a = (x, w, bias)
    return Case(
        "layernorm", f"{label}({rows}, {c}) {_dtype_name(dt)}",
        lambda a=a: k4.layernorm(*a),
        lambda a=a: k4.layernorm_reference(*a),
        _one(TOL[dt]), args=a,
        nbytes=2 * _nbytes(x) + _nbytes(w, bias), flops=8 * x.numel(),
    )


# the main path's own LayerNorm calls: (label, rows, C, dtype, seed). The
# decode's (fp32 stream: decode/cache.py) at b8 x beam 3 and b1 x beam 5, and
# the SCST sampler's at b4 x 5 samples;
# the b8 caption encoder's reduction (models/captioner.py, the bf16 stream);
# the "pallas" backbone's stage 3 and stage 0 at b8; one width of no whole
# 16-byte chunks (the any-width kernel).
MAIN_PATH_NORMS = [
    ("b8 decode ", 24, 512, torch.float32, 451), ("b1 decode ", 5, 512, torch.float32, 452),
    ("b4 sampling ", 20, 512, torch.float32, 457),
    ("b8 encoder ", 1152, 512, torch.bfloat16, 453),
    ("b8 stage3 ", 1152, 1536, torch.bfloat16, 454),
    ("b8 stage0 ", 73728, 192, torch.bfloat16, 455),
    ("any width ", 288, 130, torch.float32, 456),
]


def layernorm_cases(dev) -> Iterator[Case]:
    """Every LayerNorm width of the main path at its row count for B=2:
    Swin stages 0-3, the 4C patch-merge input, and the d512 captioner; then
    MAIN_PATH_NORMS."""
    for c, rows in [(192, 18432), (384, 4608), (768, 1152), (1536, 288),
                    (3072, 288), (512, 288)]:
        g = torch.Generator().manual_seed(400 + c)
        w = _randn((c,), g, dev, scale=0.5) + 1.0
        bias = _randn((c,), g, dev, scale=0.5)
        for dt in (torch.float32, torch.bfloat16):
            x = _randn((rows, c), g, dev, scale=2.0, dtype=dt) + 0.5
            yield _layernorm_case("", x, w, bias)
    for label, rows, c, dt, seed in MAIN_PATH_NORMS:
        g = torch.Generator().manual_seed(seed)
        w = _randn((c,), g, dev, scale=0.5) + 1.0
        bias = _randn((c,), g, dev, scale=0.5)
        yield _layernorm_case(label, _randn((rows, c), g, dev, scale=2.0, dtype=dt) + 0.5, w, bias)


def _norm(c, g, dev):
    return _randn((c,), g, dev, scale=0.2) + 1.0, _randn((c,), g, dev, scale=0.2)


def _linear(k, n, g, dev, dt, bias=True):
    """(in, out) weight of unit output variance and its fp32 bias."""
    return _randn((k, n), g, dev, scale=k**-0.5, dtype=dt), (
        _randn((n,), g, dev, scale=0.2) if bias else None)


def _ulp_bf16(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |t|: 2^(e - 8) for |t| in [2^(e-1), 2^e), 0 at 0."""
    t = t.float().abs()
    _, e = torch.frexp(t)
    return torch.where(t == 0, 0.0, torch.ldexp(torch.ones_like(t), e - 8))


def _block_plain(a):
    """B6's plain version with the two addends of its output: x1 (B4's plain
    version) and the MLP branch; x1 + branch is swin_block_reference's out."""
    x, norm1, qkv, proj, norm2, fc1, fc2, bias, m, heads, scale, eps, trans = a
    x1 = sbf.swin_attn_half_reference(x, norm1, qkv, proj, bias, m, heads, scale, eps, trans)
    branch = sbf.swin_mlp_branch_reference(x1, norm2, fc1, fc2, eps)
    return x1 + branch, x1, branch


def _block_bf16_checks(got, want):
    """B6 in bf16: out = T(x1 + T(mlp(x1))) adds two bf16-rounded addends,
    each of which may be one bf16 ulp off the plain version's without a fault
    (their sums run in other orders). Where the addends cancel, that ulp is
    larger than TOL's bound on the output, so each element may also be off by
    one ulp of each addend, taken from the plain version's own x1 and branch:
    slack only where the addends are larger than the output."""
    out, x1, branch = want
    return [("out", got, out, (*TOL[torch.bfloat16], _ulp_bf16(x1) + _ulp_bf16(branch)))]


def _block_case(a, label: str, bw: int, c: int) -> Case:
    bf16 = a[0].dtype == torch.bfloat16
    x, norm1, qkv, proj, norm2, fc1, fc2, bias, m = a[:9]
    return Case(
        "swin_block", label,
        lambda a=a: sbf.swin_block(*a),
        (lambda a=a: _block_plain(a)) if bf16 else (lambda a=a: sbf.swin_block_reference(*a)),
        _block_bf16_checks if bf16 else _one(TOL[torch.float32]), args=a,
        nbytes=2 * _nbytes(x) + _nbytes(*norm1, *qkv, *proj, *norm2, *fc1, *fc2, bias, m),
        flops=bw * N_TOKENS * (24 * c * c + 4 * N_TOKENS * c), matmul=True,
        time_plain=lambda a=a: sbf.swin_block_reference(*a),
    )


def _main_block_case(dev, b: int, stage: int, seed: int, prefix: str = "") -> Case:
    """B6 at a main-path shape, bf16 with the mask and the transition 0 -> 6."""
    c, heads, res = STAGES[stage]
    g = torch.Generator().manual_seed(seed)
    bw, dt = b * (res // WINDOW) ** 2, torch.bfloat16
    x = _randn((bw, N_TOKENS, c), g, dev, dtype=dt)
    norm1, qkv, proj = _norm(c, g, dev), _linear(c, 3 * c, g, dev, dt), _linear(c, c, g, dev, dt)
    norm2, fc1, fc2 = _norm(c, g, dev), _linear(c, 4 * c, g, dev, dt), _linear(4 * c, c, g, dev, dt)
    bias = _randn((heads, N_TOKENS, N_TOKENS), g, dev, scale=0.5)
    mask = torch.from_numpy(shift_attn_mask(res, WINDOW, SHIFT)).to(dev)
    a = (x, norm1, qkv, proj, norm2, fc1, fc2, bias, mask, heads, k1.HEAD_DIM**-0.5, 1e-5,
         (res, 0, SHIFT))
    return _block_case(a, f"{prefix}b{b} stage{stage} x{tuple(x.shape)} mask trans0to6 bfloat16",
                       bw, c)


def swin_block_cases(dev) -> Iterator[Case]:
    """B6 on the two stages that run it (C = 192 and 384) at B=2: block 0 (no
    mask, no transition) and block 1 (mask, transition 0 -> 6), fp32 and bf16;
    then the main path's own shapes (MAIN_PATH_BLOCKS) and EXTRA_BLOCK_SEEDS."""
    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, heads, res) in enumerate(STAGES[:2]):
            g = torch.Generator().manual_seed(1100 + stage)
            bw = 2 * (res // WINDOW) ** 2
            x = _randn((bw, N_TOKENS, c), g, dev, dtype=dt)
            norm1, qkv, proj = _norm(c, g, dev), _linear(c, 3 * c, g, dev, dt), _linear(c, c, g, dev, dt)
            norm2, fc1, fc2 = _norm(c, g, dev), _linear(c, 4 * c, g, dev, dt), _linear(4 * c, c, g, dev, dt)
            bias = _randn((heads, N_TOKENS, N_TOKENS), g, dev, scale=0.5)
            mask = torch.from_numpy(shift_attn_mask(res, WINDOW, SHIFT)).to(dev)
            for m, trans in ((None, None), (mask, (res, 0, SHIFT))):
                a = (x, norm1, qkv, proj, norm2, fc1, fc2, bias, m, heads, k1.HEAD_DIM**-0.5,
                     1e-5, trans)
                name = "notrans" if trans is None else f"trans{trans[1]}to{trans[2]}"
                yield _block_case(
                    a, f"stage{stage} x{tuple(x.shape)} {'mask' if m is not None else 'nomask'} "
                    f"{name} {_dtype_name(dt)}", bw, c)
    # the main path's own shapes, bf16 with the mask and the transition 0 -> 6:
    # stages 0 and 1 at b8 (serve) and b1 (latency)
    for b, stage in MAIN_PATH_BLOCKS:
        yield _main_block_case(dev, b, stage, 1240 + 10 * b + stage)
    for b, stage, seed in EXTRA_BLOCK_SEEDS:
        yield _main_block_case(dev, b, stage, seed, prefix=f"seed{seed} ")


# (batch, stage) of the main path's whole-block shapes with cases of their own
MAIN_PATH_BLOCKS = [(8, 0), (8, 1), (1, 0), (1, 1)]
# (batch, stage, seed) of further whole-block cases at main-path shapes: the
# b8 stage-1 draw of the first seed base (1140), whose output adds x1 and
# the MLP branch where they nearly cancel
EXTRA_BLOCK_SEEDS = [(8, 1, 1221)]


def swin_attn_half_cases(dev) -> Iterator[Case]:
    """B4 on the three multi-window stages at B=2: block 0 (no mask, no
    transition), a shifted block (mask, transition 0 -> 6), a later plain block
    (no mask, transition 6 -> 0) and a shifted block without transition; fp32
    and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, heads, res) in enumerate(STAGES[:3]):
            g = torch.Generator().manual_seed(500 + stage)
            bw = 2 * (res // WINDOW) ** 2
            x = _randn((bw, N_TOKENS, c), g, dev, dtype=dt)
            norm1, qkv, proj = _norm(c, g, dev), _linear(c, 3 * c, g, dev, dt), _linear(c, c, g, dev, dt)
            bias = _randn((heads, N_TOKENS, N_TOKENS), g, dev, scale=0.5)
            mask = torch.from_numpy(shift_attn_mask(res, WINDOW, SHIFT)).to(dev)
            for m, trans in ((None, None), (mask, (res, 0, SHIFT)), (None, (res, SHIFT, 0)),
                             (mask, None)):
                a = (x, norm1, qkv, proj, bias, m, heads, k1.HEAD_DIM**-0.5, 1e-5, trans)
                name = "notrans" if trans is None else f"trans{trans[1]}to{trans[2]}"
                yield Case(
                    "swin_attn_half",
                    f"stage{stage} x{tuple(x.shape)} {'mask' if m is not None else 'nomask'} "
                    f"{name} {_dtype_name(dt)}",
                    lambda a=a: sbf.swin_attn_half(*a),
                    lambda a=a: sbf.swin_attn_half_reference(*a),
                    _one(TOL[dt]), args=a,
                    nbytes=2 * _nbytes(x) + _nbytes(*norm1, *qkv, *proj, bias, m),
                    flops=bw * N_TOKENS * (8 * c * c + 4 * N_TOKENS * c), matmul=True,
                )
    # the main path's own shapes, bf16 with the mask and the transition 0 -> 6:
    # stage 2 at b8 (serve) and b1 (latency), stage 0 at b8 on the halves
    for b, stage in MAIN_PATH_HALVES:
        c, heads, res = STAGES[stage]
        g = torch.Generator().manual_seed(540 + 10 * b + stage)
        bw = b * (res // WINDOW) ** 2
        x = _randn((bw, N_TOKENS, c), g, dev, dtype=torch.bfloat16)
        norm1 = _norm(c, g, dev)
        qkv, proj = _linear(c, 3 * c, g, dev, torch.bfloat16), _linear(c, c, g, dev, torch.bfloat16)
        bias = _randn((heads, N_TOKENS, N_TOKENS), g, dev, scale=0.5)
        mask = torch.from_numpy(shift_attn_mask(res, WINDOW, SHIFT)).to(dev)
        a = (x, norm1, qkv, proj, bias, mask, heads, k1.HEAD_DIM**-0.5, 1e-5, (res, 0, SHIFT))
        yield Case(
            "swin_attn_half", f"b{b} stage{stage} x{tuple(x.shape)} mask trans0to6 bfloat16",
            lambda a=a: sbf.swin_attn_half(*a),
            lambda a=a: sbf.swin_attn_half_reference(*a),
            _one(TOL[torch.bfloat16]), args=a,
            nbytes=2 * _nbytes(x) + _nbytes(*norm1, *qkv, *proj, bias, mask),
            flops=bw * N_TOKENS * (8 * c * c + 4 * N_TOKENS * c), matmul=True,
        )


# (batch, stage) of the main path's half-block shapes with cases of their own
# (stages 0 and 1: the halves' side of the comparison with B6)
MAIN_PATH_HALVES = [(8, 2), (1, 2), (8, 0), (8, 1), (1, 0), (1, 1)]


def swin_mlp_half_cases(dev) -> Iterator[Case]:
    """B5 on the rows of the three multi-window stages at B=2, fp32 and bf16;
    then at the main path's own shapes (MAIN_PATH_HALVES), bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, _, res) in enumerate(STAGES[:3]):
            g = torch.Generator().manual_seed(600 + stage)
            x = _randn((2 * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=dt)
            norm2, fc1, fc2 = _norm(c, g, dev), _linear(c, 4 * c, g, dev, dt), _linear(4 * c, c, g, dev, dt)
            a = (x, norm2, fc1, fc2, 1e-5)
            yield Case(
                "swin_mlp_half", f"stage{stage} x{tuple(x.shape)} {_dtype_name(dt)}",
                lambda a=a: sbf.swin_mlp_half(*a),
                lambda a=a: sbf.swin_mlp_half_reference(*a),
                _one(TOL[dt]), args=a,
                nbytes=2 * _nbytes(x) + _nbytes(*norm2, *fc1, *fc2),
                flops=x.numel() * 16 * c, matmul=True,
            )
    for b, stage in MAIN_PATH_HALVES:
        c, _, res = STAGES[stage]
        g = torch.Generator().manual_seed(640 + 10 * b + stage)
        x = _randn((b * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=torch.bfloat16)
        norm2 = _norm(c, g, dev)
        fc1 = _linear(c, 4 * c, g, dev, torch.bfloat16)
        fc2 = _linear(4 * c, c, g, dev, torch.bfloat16)
        a = (x, norm2, fc1, fc2, 1e-5)
        yield Case(
            "swin_mlp_half", f"b{b} stage{stage} x{tuple(x.shape)} bfloat16",
            lambda a=a: sbf.swin_mlp_half(*a),
            lambda a=a: sbf.swin_mlp_half_reference(*a),
            _one(TOL[torch.bfloat16]), args=a,
            nbytes=2 * _nbytes(x) + _nbytes(*norm2, *fc1, *fc2),
            flops=x.numel() * 16 * c, matmul=True,
        )


def window_transition_cases(dev) -> Iterator[Case]:
    """B11 on the three multi-window stages at B=2, both directions, fp32 and
    bf16. A copy: the kernel must equal the plain version exactly."""
    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, _, res) in enumerate(STAGES[:3]):
            g = torch.Generator().manual_seed(700 + stage)
            x = _randn((2 * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=dt)
            for f, t in ((SHIFT, 0), (0, SHIFT)):
                a = (x, res, WINDOW, f, t)
                yield Case(
                    "window_transition",
                    f"stage{stage} x{tuple(x.shape)} {f}to{t} {_dtype_name(dt)}",
                    lambda a=a: sbf.window_transition(*a),
                    lambda a=a: sbf.window_transition_reference(*a),
                    _one(EXACT), args=a, nbytes=2 * _nbytes(x),
                )


def _embed_case(x, g, dev, label) -> Case:
    dt = x.dtype
    proj, norm = _linear(48, 192, g, dev, dt), _norm(192, g, dev)
    a = (x, proj, norm, WINDOW, 1e-5)
    return Case(
        "patch_embed", label,
        lambda a=a: sb.patch_embed_fused(*a),
        lambda a=a: sb.patch_embed_reference(*a),
        _one(TOL[dt]), args=a,
        nbytes=_nbytes(x, *proj, *norm) + x.numel() // 48 * 192 * x.element_size(),
        flops=2 * x.numel() * 192, matmul=True,
    )


def patch_embed_cases(dev) -> Iterator[Case]:
    """B7 at B=2: (2, 96, 96, 48) space-to-depth rows -> (128, 144, 192),
    fp32 and bf16; then the main path's own batches (MAIN_PATH_EMBEDS), bf16."""
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(800)
        x = _randn((2, 96, 96, 48), g, dev, dtype=dt)
        yield _embed_case(x, g, dev, f"x{tuple(x.shape)} C192 {_dtype_name(dt)}")
    for b in MAIN_PATH_EMBEDS:
        g = torch.Generator().manual_seed(810 + b)
        x = _randn((b, 96, 96, 48), g, dev, dtype=torch.bfloat16)
        yield _embed_case(x, g, dev, f"b{b} stage0 x{tuple(x.shape)} C192 bfloat16")


# batches of the main path's patch embeds with cases of their own (serve, latency)
MAIN_PATH_EMBEDS = [8, 1]


def _merge_case(x, g, dev, label, stage) -> Case:
    """B8 on x, the window layout after `stage`. Its bf16 product alone
    (time_alone): the second launch, on what a first full call left in
    scratch (the row statistics, or the normalized rows)."""
    c, _, res = STAGES[stage]
    dt = x.dtype
    norm, (w, _) = _norm(4 * c, g, dev), _linear(4 * c, 2 * c, g, dev, dt, bias=False)
    a = (x, norm, w, res // WINDOW, WINDOW, 1e-5)
    alone = None
    if dt == torch.bfloat16:
        scratch = []

        def alone(a=a, scratch=scratch):
            if not scratch:  # the first launch once, outside any timing
                scratch.append(sb.downsample_scratch(x, sb.downsample_plan(x)))
                sb.downsample_launch(*a, scratch=scratch[0])
            return sb.downsample_launch(*a, scratch=scratch[0], prologue_ready=True)
    return Case(
        "downsample", label,
        lambda a=a: sb.downsample_fused(*a),
        lambda a=a: sb.downsample_reference(*a),
        _one(TOL[dt]), args=a,
        nbytes=_nbytes(x, *norm, w) + _nbytes(x) // 2,
        flops=x.numel() * 4 * c, matmul=True, time_alone=alone,
    )


def downsample_cases(dev) -> Iterator[Case]:
    """B8 at B=2 after each of the three multi-window stages, fp32 and bf16;
    then at the main path's own shapes (MAIN_PATH_MERGES), bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, _, res) in enumerate(STAGES[:3]):
            g = torch.Generator().manual_seed(900 + stage)
            x = _randn((2 * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=dt)
            yield _merge_case(x, g, dev, f"stage{stage} x{tuple(x.shape)} {_dtype_name(dt)}",
                              stage)
    for b, stage in MAIN_PATH_MERGES:
        c, _, res = STAGES[stage]
        g = torch.Generator().manual_seed(940 + 10 * b + stage)
        x = _randn((b * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=torch.bfloat16)
        yield _merge_case(x, g, dev, f"b{b} stage{stage} x{tuple(x.shape)} bfloat16", stage)


# (batch, stage) of the main path's patch mergings with cases of their own:
# after each multi-window stage at the serve and the latency batch
MAIN_PATH_MERGES = [(8, 0), (8, 1), (8, 2), (1, 0), (1, 1), (1, 2)]


def _rel_to_max(t):
    """Tolerance of a gradient against its plain version: t times the largest
    magnitude of the tensor. The sums over every row or window of the grid
    run in another order than the plain version's (chunks of rows or windows,
    then the chunks in order), so single elements near zero are held to the
    size of the tensor, not to their own."""
    return lambda want: (t * float(want.float().abs().max()), 0.0)


# gradients, relative to each tensor's max: fp32 differs in summation order
# only; bf16 operands are rounded at the same places on both sides, and a
# flipped rounding upstream moves a sum by a fraction of a bf16 ulp of its terms
GRAD_TOL = {torch.float32: _rel_to_max(2e-5), torch.bfloat16: _rel_to_max(2e-2)}


def _scales(b, dev, zero_at):
    """(B,) fp32 stochastic-depth scales: 1 / keep with image zero_at dropped
    (none where the batch has no such image)."""
    m = torch.full((b,), 1.0 / 0.9)
    if zero_at < b:
        m[zero_at] = 0.0
    return m.to(dev)


def _named(names, tol_of):
    def checks(got, want):
        return [(n, g_, w_, tol_of(w_)) for n, g_, w_ in zip(names, got, want)]
    return checks


def _block_operands(stage, seed, dev, dt, b=2):
    c, heads, res = STAGES[stage]
    g = torch.Generator().manual_seed(seed + stage)
    bw = b * (res // WINDOW) ** 2
    x = _randn((bw, N_TOKENS, c), g, dev, dtype=dt)
    dy = _randn((bw, N_TOKENS, c), g, dev, dtype=dt)
    ops = dict(
        norm1=_norm(c, g, dev), qkv=_linear(c, 3 * c, g, dev, dt), proj=_linear(c, c, g, dev, dt),
        norm2=_norm(c, g, dev), fc1=_linear(c, 4 * c, g, dev, dt), fc2=_linear(4 * c, c, g, dev, dt),
        bias=_randn((heads, N_TOKENS, N_TOKENS), g, dev, scale=0.5),
        mask=torch.from_numpy(shift_attn_mask(res, WINDOW, SHIFT)).to(dev),
        m1=_scales(b, dev, 1), m2=_scales(b, dev, 0),
    )
    return x, dy, ops, heads, k1.HEAD_DIM**-0.5


def swin_block_train_cases(dev) -> Iterator[Case]:
    """B9a on the two stages that run it at B=2, with and without the mask,
    one image dropped on each branch; checks y and x2; fp32 and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage in (0, 1):
            x, _, o, heads, scale = _block_operands(stage, 1200, dev, dt)
            c = x.shape[-1]
            for m in (o["mask"], None):
                a = (x, o["norm1"], o["qkv"], o["proj"], o["norm2"], o["fc1"], o["fc2"],
                     o["bias"], m, o["m1"], o["m2"], heads, scale, 1e-5)
                yield Case(
                    "swin_block_train",
                    f"stage{stage} x{tuple(x.shape)} {'mask' if m is not None else 'nomask'} "
                    f"{_dtype_name(dt)}",
                    lambda a=a: sbf.swin_block_train_forward(*a),
                    lambda a=a: sbf.swin_block_train_reference(*a),
                    _named(("y", "x2"), lambda w_, dt=dt: TOL[dt]), args=a,
                    nbytes=3 * _nbytes(x) + _nbytes(
                        *o["norm1"], *o["qkv"], *o["proj"], *o["norm2"], *o["fc1"], *o["fc2"],
                        o["bias"], m, o["m1"], o["m2"]),
                    flops=x.shape[0] * N_TOKENS * (24 * c * c + 4 * N_TOKENS * c), matmul=True,
                )
    # the XE step's own batch (b4), stages 0 and 1, bf16 with the mask
    for stage in (0, 1):
        x, _, o, heads, scale = _block_operands(stage, 1240, dev, torch.bfloat16, b=4)
        c = x.shape[-1]
        a = (x, o["norm1"], o["qkv"], o["proj"], o["norm2"], o["fc1"], o["fc2"], o["bias"],
             o["mask"], o["m1"], o["m2"], heads, scale, 1e-5)
        yield Case(
            "swin_block_train", f"b4 stage{stage} x{tuple(x.shape)} mask bfloat16",
            lambda a=a: sbf.swin_block_train_forward(*a),
            lambda a=a: sbf.swin_block_train_reference(*a),
            _named(("y", "x2"), lambda w_: TOL[torch.bfloat16]), args=a,
            nbytes=3 * _nbytes(x) + _nbytes(
                *o["norm1"], *o["qkv"], *o["proj"], *o["norm2"], *o["fc1"], *o["fc2"],
                o["bias"], o["mask"], o["m1"], o["m2"]),
            flops=x.shape[0] * N_TOKENS * (24 * c * c + 4 * N_TOKENS * c), matmul=True,
        )


def swin_attn_half_train_cases(dev) -> Iterator[Case]:
    """B10a on the three multi-window stages at B=2, with and without the
    mask, one image dropped; fp32 and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage in (0, 1, 2):
            x, _, o, heads, scale = _block_operands(stage, 1300, dev, dt)
            c = x.shape[-1]
            for m in (o["mask"], None):
                a = (x, o["norm1"], o["qkv"], o["proj"], o["bias"], m, o["m1"], heads, scale, 1e-5)
                yield Case(
                    "swin_attn_half_train",
                    f"stage{stage} x{tuple(x.shape)} {'mask' if m is not None else 'nomask'} "
                    f"{_dtype_name(dt)}",
                    lambda a=a: sbf.swin_attn_half_train_forward(*a),
                    lambda a=a: sbf.swin_attn_half_train_reference(*a),
                    _one(TOL[dt]), args=a,
                    nbytes=2 * _nbytes(x) + _nbytes(
                        *o["norm1"], *o["qkv"], *o["proj"], o["bias"], m, o["m1"]),
                    flops=x.shape[0] * N_TOKENS * (8 * c * c + 4 * N_TOKENS * c), matmul=True,
                )


def swin_mlp_half_train_cases(dev) -> Iterator[Case]:
    """B10b on the rows of the three multi-window stages at B=2, one image
    dropped; fp32 and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage in (0, 1, 2):
            x, _, o, _, _ = _block_operands(stage, 1400, dev, dt)
            a = (x, o["norm2"], o["fc1"], o["fc2"], o["m2"], 1e-5)
            yield Case(
                "swin_mlp_half_train", f"stage{stage} x{tuple(x.shape)} {_dtype_name(dt)}",
                lambda a=a: sbf.swin_mlp_half_train_forward(*a),
                lambda a=a: sbf.swin_mlp_half_train_reference(*a),
                _one(TOL[dt]), args=a,
                nbytes=2 * _nbytes(x) + _nbytes(*o["norm2"], *o["fc1"], *o["fc2"], o["m2"]),
                flops=x.numel() * 16 * x.shape[-1], matmul=True,
            )


def _mlp_bwd_case(label, x2, dy, o, fc1, dt) -> Case:
    c = x2.shape[-1]
    a = (x2, dy, o["norm2"], fc1, o["fc2"], o["m2"], 1e-5)
    return Case(
        "swin_mlp_bwd", label,
        lambda a=a: sbf.swin_mlp_bwd(*a),
        lambda a=a: sbf.swin_mlp_bwd_reference(*a),
        _named(("dx2", "dg2", "dbe2", "dw1", "db1", "dw2", "db2"), GRAD_TOL[dt]), args=a,
        # x2, dy in and dx2 out; the weights in and their fp32 gradients out
        nbytes=3 * _nbytes(x2) + _nbytes(*o["norm2"], *fc1, o["fc2"][0], o["m2"])
        + 4 * (8 * c * c + 7 * c),
        flops=x2.numel() * 40 * c, matmul=True,
    )


def swin_mlp_bwd_cases(dev) -> Iterator[Case]:
    """B9c on the rows of the three multi-window stages at B=2, one image
    dropped, one case without the fc1 bias; all seven gradients; fp32 and
    bf16. Then the XE step's own batch (b4) at each of those stages, bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage in (0, 1, 2):
            x2, dy, o, _, _ = _block_operands(stage, 1500, dev, dt)
            fc1 = o["fc1"] if stage else (o["fc1"][0], None)
            yield _mlp_bwd_case(f"stage{stage} x{tuple(x2.shape)} {_dtype_name(dt)}", x2, dy, o,
                                fc1, dt)
    for stage in (0, 1, 2):
        x2, dy, o, _, _ = _block_operands(stage, 1540, dev, torch.bfloat16, b=4)
        yield _mlp_bwd_case(f"b4 stage{stage} x{tuple(x2.shape)} bfloat16", x2, dy, o, o["fc1"],
                            torch.bfloat16)


def _attn_bwd_case(label, x, dy, o, qkv, m, heads, scale, dt) -> Case:
    c = x.shape[-1]
    a = (x, dy, o["norm1"], qkv, o["proj"], o["bias"], m, o["m1"], heads, scale, 1e-5)
    return Case(
        "swin_attn_bwd", label,
        lambda a=a: sbf.swin_attn_bwd(*a),
        lambda a=a: sbf.swin_attn_bwd_reference(*a),
        _named(("dx", "dg1", "dbe1", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"),
               GRAD_TOL[dt]), args=a,
        # x, dx2 in and dx out; weights, bias and mask in; fp32 gradients out
        nbytes=3 * _nbytes(x) + _nbytes(*o["norm1"], *qkv, o["proj"][0], o["bias"], m, o["m1"])
        + 4 * (4 * c * c + 6 * c) + _nbytes(o["bias"]),
        flops=x.shape[0] * N_TOKENS * (22 * c * c + 12 * N_TOKENS * c), matmul=True,
    )


def swin_attn_bwd_cases(dev) -> Iterator[Case]:
    """B9b on the three multi-window stages at B=2, with and without the
    mask, one image dropped, one case without the qkv bias; all eight
    gradients (dbias among them); fp32 and bf16. Then the XE step's own batch
    (b4) at each of those stages, with the mask, bf16."""
    for dt in (torch.float32, torch.bfloat16):
        for stage in (0, 1, 2):
            x, dy, o, heads, scale = _block_operands(stage, 1600, dev, dt)
            for m in (o["mask"], None):
                qkv = o["qkv"] if m is not None else (o["qkv"][0], None)
                yield _attn_bwd_case(
                    f"stage{stage} x{tuple(x.shape)} {'mask' if m is not None else 'nomask'} "
                    f"{_dtype_name(dt)}", x, dy, o, qkv, m, heads, scale, dt)
    for stage in (0, 1, 2):
        x, dy, o, heads, scale = _block_operands(stage, 1640, dev, torch.bfloat16, b=4)
        yield _attn_bwd_case(f"b4 stage{stage} x{tuple(x.shape)} mask bfloat16", x, dy, o,
                             o["qkv"], o["mask"], heads, scale, torch.bfloat16)


def _int8_weight(n, k, g, dev):
    """(w_q (N, K) int8, scale fp32 (N,)): uniform int8 codes and scales that
    give the product unit output variance for unit inputs."""
    w_q = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    scale = (torch.rand((n,), generator=g) + 0.5) * (k**-0.5 / 73.0)
    return w_q.to(dev), scale.to(dev)


def _within_max(t):
    """Tolerance t times the largest magnitude of the wanted tensor."""
    return lambda want: (t * float(want.float().abs().max()), 0.0)


def quant_matmul_cases(dev) -> Iterator[Case]:
    """B12 at the main path's shapes: Swin-L stage 3's fc1 (B = 2, 288 rows,
    1536 -> 6144), the cross K/V at b8 (1152 rows, 512 -> 512), a decoder
    linear at b8 / beam 3 (24 rows, 512 -> 2048) and b1 / beam 5 (5 rows),
    the vocab linear at both (512 -> 10000, a ragged last column tile) and
    the patch embed (B = 2, 18432 rows, 48 -> 192); the dynamic scale in fp32
    and bf16, and one calibrated fp32 scale on bf16 x. Both product routes
    (small M up to 64 rows, large above) and both forms of the dynamic scale
    (one CTA, two passes) run. The int8 x must equal the plain version's bit
    for bit; the output is within 1e-6 of its max (the int32 sums are exact on
    both sides; fp32 roundings of the epilogue remain)."""
    shapes = [("stage3 fc1", 288, 1536, 6144), ("decode ff", 24, 512, 2048),
              ("vocab", 24, 512, VOCAB), ("patch embed", 18432, 48, 192),
              ("b1 decode ff", 5, 512, 2048), ("b1 vocab", 5, 512, VOCAB),
              ("cross K/V", 1152, 512, 512)]
    runs = [(name, m, k, n, dt, False) for name, m, k, n in shapes
            for dt in (torch.float32, torch.bfloat16)]
    runs.append(("decode ff", 24, 512, 2048, torch.bfloat16, True))
    for name, m, k, n, dt, static in runs:
        yield _quant_matmul_case(dev, name, m, k, n, dt, static)


def _quant_matmul_case(dev, name, m, k, n, dt, static, seed=None) -> Case:
    g = torch.Generator().manual_seed(1700 + k + n if seed is None else seed)
    x = _randn((m, k), g, dev, scale=1.5, dtype=dt)
    w_q, scale = _int8_weight(n, k, g, dev)
    bias = _randn((n,), g, dev, scale=0.2)
    x_scale = torch.tensor(2.5 / 127.0, device=dev) if static else None
    a = (x, w_q, scale, bias, x_scale)

    def run(fn, a=a):
        xq = torch.empty(a[0].shape, dtype=torch.int8, device=a[0].device)
        return fn(*a, xq_out=xq), xq

    def checks(got, want):
        (out, xq), (want_out, want_xq) = got, want
        return [("xq int8", xq, want_xq, EXACT),
                ("out", out, want_out, _within_max(1e-6)(want_out))]

    xq, s_x = qm.quantize_activation_reference(x, x_scale)
    return Case(
        "quant_matmul",
        f"{name} x({m}, {k}) N{n} {_dtype_name(dt)}{' static' if static else ''}",
        lambda run=run: run(qm.quantized_matmul),
        lambda run=run: run(qm.quantized_matmul_reference),
        checks, args=a,
        nbytes=_nbytes(x, w_q, scale, bias, x_scale) + 4 * m * n,
        flops=2 * m * n * k, int8=True,
        time_kernel=lambda a=a: qm.quantized_matmul(*a),
        time_plain=lambda a=a: qm.quantized_matmul_reference(*a),
        time_alone=lambda: qm.int8_product(xq, s_x, w_q, scale, bias),
    )


def quantize_act_cases(dev) -> Iterator[Case]:
    """B12's first part, the scale and the int8 x, at stage 3's fc1 (288 x
    1536: the two-pass dynamic form), the decode ff's input at b8 / beam 3
    (24 x 512, and its fc2's 24 x 2048: one CTA) and with a calibrated fp32
    scale on bf16 x. The int8 x and the fp32 scale must be equal."""
    runs = [(288, 1536, dt, False) for dt in (torch.float32, torch.bfloat16)]
    runs += [(24, k, dt, False) for k in (512, 2048) for dt in (torch.float32, torch.bfloat16)]
    runs.append((24, 512, torch.bfloat16, True))
    for m, k, dt, static in runs:
        g = torch.Generator().manual_seed(1900 + m + k)
        x = _randn((m, k), g, dev, scale=1.5, dtype=dt)
        x_scale = torch.tensor(2.5 / 127.0, device=dev) if static else None

        def run_kernel(x=x, x_scale=x_scale):
            xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
            return xq, qm.quantize_activation(x, x_scale, xq)

        yield Case(
            "quantize_act",
            f"x({m}, {k}) {_dtype_name(dt)} {'calibrated' if static else 'dynamic'}",
            run_kernel, lambda x=x, x_scale=x_scale: qm.quantize_activation_reference(x, x_scale),
            lambda got, want: [("xq int8", got[0], want[0], EXACT),
                               ("scale", got[1], want[1], EXACT)],
            args=(x, x_scale), nbytes=_nbytes(x, x_scale) + x.numel() + 4,
        )


def swin_mlp_half_a8_cases(dev) -> Iterator[Case]:
    """B13 on the rows of the three multi-window stages at B=2, fp32 and bf16.
    LN and GELU round at other places on the card (fp32 sums in another
    order, erff against torch's erf), which now and then moves a value across
    an int8 rounding boundary; such a step in LN2's int8 row moves the whole
    row's output by about 3e-3 of the output's max. So: at most 0.1% of the
    int8 values of LN2's rows and of the hidden rows differ, by one step; on
    the rows whose int8 values all agree, the output within 1e-5 of its max
    at fp32 (2e-2 + 2e-2 relative at bf16, a bf16 ulp); on every row within
    1e-2 (fp32) / 2e-2 (bf16) of its max."""
    def checks_of(dt):
        def checks(got, want):
            (out, xq, hq), (want_out, want_xq, want_hq) = got, want
            zero = torch.zeros((), device=out.device)
            parts = []
            same = torch.ones(xq.shape[0], dtype=torch.bool, device=out.device)
            for name, a, b in (("LN2", xq, want_xq), ("hidden", hq, want_hq)):
                steps = (a.int() - b.int()).abs()
                same &= (steps == 0).all(dim=1)
                parts += [(f"{name} int8 share off", (steps > 0).float().mean(), zero, (1e-3, 0.0)),
                          (f"{name} int8 largest step", steps.max().float(), zero, (1.0, 0.0))]
            c = out.shape[-1]
            rows, want_rows = out.reshape(-1, c)[same], want_out.reshape(-1, c)[same]
            agree_tol = _within_max(1e-5)(want_out) if dt == torch.float32 else TOL[dt]
            all_tol = _within_max(1e-2 if dt == torch.float32 else 2e-2)(want_out)
            return parts + [("out, rows whose int8 agree", rows, want_rows, agree_tol),
                            ("out", out, want_out, all_tol)]
        return checks

    def case(x, label, g):
        c = x.shape[-1]
        norm2 = _norm(c, g, dev)
        fc1 = (*_int8_weight(4 * c, c, g, dev), _randn((4 * c,), g, dev, scale=0.2))
        fc2 = (*_int8_weight(c, 4 * c, g, dev), _randn((c,), g, dev, scale=0.2))
        a = (x, norm2, fc1, fc2, 1e-5)
        return Case(
            "swin_mlp_half_a8", label,
            lambda a=a: sbf.swin_mlp_half_a8(*a, hidden=True),
            lambda a=a: sbf.swin_mlp_half_a8_reference(*a, hidden=True),
            checks_of(x.dtype), args=a,
            nbytes=2 * _nbytes(x) + _nbytes(*norm2, *fc1, *fc2),
            flops=x.numel() * 16 * c, int8=True,
            time_kernel=lambda a=a: sbf.swin_mlp_half_a8(*a),
            time_plain=lambda a=a: sbf.swin_mlp_half_a8_reference(*a),
        )

    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, _, res) in enumerate(STAGES[:3]):
            g = torch.Generator().manual_seed(1800 + stage)
            x = _randn((2 * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=dt)
            yield case(x, f"stage{stage} x{tuple(x.shape)} {_dtype_name(dt)}", g)
    # the main path's own shapes (MAIN_PATH_A8), bf16
    for b, stage in MAIN_PATH_A8:
        c, _, res = STAGES[stage]
        g = torch.Generator().manual_seed(1900 + 10 * b + stage)
        x = _randn((b * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=torch.bfloat16)
        yield case(x, f"b{b} stage{stage} x{tuple(x.shape)} bfloat16", g)


# (batch, stage) of the main path's w8a8 MLP-half shapes with cases of their
# own: every stage of the serve batch, and the latency batch's widest
MAIN_PATH_A8 = [(8, 0), (8, 1), (8, 2), (1, 2)]


CASES = {
    "window_attention": window_attention_cases,
    "dyn_exp_step": dyn_exp_step_cases,
    "topk": topk_cases,
    "layernorm": layernorm_cases,
    "patch_embed": patch_embed_cases,
    "downsample": downsample_cases,
    "swin_attn_half": swin_attn_half_cases,
    "swin_mlp_half": swin_mlp_half_cases,
    "window_transition": window_transition_cases,
    "swin_block": swin_block_cases,
    "dyn_exp_cross_step": dyn_exp_cross_step_cases,
    "swin_block_train": swin_block_train_cases,
    "swin_attn_half_train": swin_attn_half_train_cases,
    "swin_mlp_half_train": swin_mlp_half_train_cases,
    "swin_mlp_bwd": swin_mlp_bwd_cases,
    "swin_attn_bwd": swin_attn_bwd_cases,
    "quant_matmul": quant_matmul_cases,
    "quantize_act": quantize_act_cases,
    "swin_mlp_half_a8": swin_mlp_half_a8_cases,
}


def op_calls(fn) -> List[tuple]:
    """The `odic` op calls fn makes, in order, as (op, args, kwargs), each
    also run: what `torch.library.opcheck` is given."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "odic":
                calls.append((func, args, kwargs or {}))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return calls


def opcheck_calls(dev) -> Iterator[Tuple[str, Callable[[], object]]]:
    """(label, call) reaching every `odic` op at the main path's shapes: the
    first case of each inference kernel whose inputs hold no NaN (opcheck
    compares outputs with NaN as unequal), both of B13's products alone, and
    the shared product plain, with its LayerNorm and GELU, and with the
    window transition gathered into it and its residual."""
    from . import fused_linear as fl

    def no_nan(case):
        return not any(isinstance(a, torch.Tensor) and a.is_floating_point()
                       and bool(torch.isnan(a).any()) for a in case.args)

    for name in ("window_attention", "dyn_exp_step", "topk", "layernorm", "patch_embed",
                 "downsample", "swin_attn_half", "swin_mlp_half", "window_transition",
                 "swin_block", "dyn_exp_cross_step", "quant_matmul", "swin_mlp_half_a8"):
        case = next(c for c in CASES[name](dev) if no_nan(c))
        yield f"{name} {case.label}", case.run_kernel
    g = torch.Generator().manual_seed(3100)
    rows, c, hid = 2 * 144, 768, 3072
    a_q = torch.randint(-127, 128, (rows, c), generator=g, dtype=torch.int8).to(dev)
    a_scale = (torch.rand((rows,), generator=g) + 0.5).to(dev)
    w1, s1 = _int8_weight(hid, c, g, dev)
    w2, s2 = _int8_weight(c, hid, g, dev)
    b1, b2 = _randn((hid,), g, dev), _randn((c,), g, dev)
    h_q = torch.randint(-127, 128, (rows, hid), generator=g, dtype=torch.int8).to(dev)
    resid = _randn((rows, c), g, dev, dtype=torch.bfloat16)
    yield "mlp_a8_product fc1", lambda: sbf.mlp_a8_product(a_q, a_scale, (w1, s1, b1))
    yield "mlp_a8_product fc2", lambda: sbf.mlp_a8_product(h_q, a_scale * 127, (w2, s2, b2),
                                                              resid)
    dt = torch.bfloat16
    x = _randn((8 * 144, 768), g, dev, dtype=dt)
    w, b = _linear(768, 768, g, dev, dt)
    ln = _norm(768, g, dev)
    gather = ("transition", 24, 12, 6)
    yield "fused_linear", lambda: fl.fused_linear(x, w, b)
    yield "fused_linear ln gelu", lambda: fl.fused_linear(x, w, b, ln, gelu=True)
    yield "fused_linear gathered", lambda: fl.fused_linear(
        x, w, b, ln, gather=gather, resid=x, resid_gather=gather)


def compare(got: torch.Tensor, want: torch.Tensor, tol):
    """(max abs error, max rel error, ok) of got against want under
    |got - want| <= atol + rtol |want| (+ slack, where tol is (atol, rtol,
    slack) with an elementwise slack tensor). NaN matches NaN and an infinity
    matches the same infinity; anything else non-finite fails."""
    atol, rtol = tol[:2]
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return float("inf"), float("inf"), False
    if g.numel() == 0:
        return 0.0, 0.0, True
    diff, w_abs = _diff(g, w)
    rel = diff / w_abs.clamp_min(1e-6)
    bound = atol + rtol * w_abs + (tol[2].float() if len(tol) > 2 else 0.0)
    ok = not bool((diff > bound).any())
    return float(diff.max()), float(rel.max()), ok


def _diff(g: torch.Tensor, w: torch.Tensor):
    """|g - w| (0 where both are the same NaN or infinity, inf where either
    is otherwise non-finite) and |w| (0 where not finite)."""
    special = (torch.isnan(g) & torch.isnan(w)) | (torch.isinf(g) & (g == w))
    finite = torch.isfinite(g) & torch.isfinite(w)
    diff = torch.where(special, 0.0, torch.where(finite, (g - w).abs(), float("inf")))
    return diff, torch.where(finite, w.abs(), 0.0)


def slack_used(got: torch.Tensor, want: torch.Tensor, tol) -> int:
    """Elements within the slack of a (atol, rtol, slack) tolerance that
    atol + rtol |want| alone would not hold."""
    if len(tol) < 3 or got.shape != want.shape:
        return 0
    diff, w_abs = _diff(got.float(), want.float())
    return int((diff > tol[0] + tol[1] * w_abs).sum())
