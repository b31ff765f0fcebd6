"""Main-path cases for holding each hand-written kernel against its plain
PyTorch version on CUDA tensors, with the tolerance of every check.

The shapes are the ones the main path gives each kernel: Swin-L/384 windows
at B=2 (for the window-resident path's kernels too: every stage width, masked
and unmasked, with and without the shift transition), the d512 decoder at
B·beam = 24 rows (with its cross-attention over 144 encoder tokens for the
fused step), V = 10000 log-prob rows, and every LayerNorm width.
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
    random 0/-100 mask stands in so the masked branch runs there too."""
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        for stage, (c, heads, res) in enumerate(STAGES):
            nw = (res // 12) ** 2
            g = torch.Generator().manual_seed(100 + stage)
            qkv = _randn((2 * nw, 144, 3 * c), g, dev, dtype=dt)
            bias = _randn((heads, 144, 144), g, dev, scale=0.5)
            if nw > 1:
                mask = torch.from_numpy(shift_attn_mask(res, 12, 6)).to(dev)
            else:
                mask = torch.where(torch.rand((1, 144, 144), generator=g) > 0.7, -100.0, 0.0)
                mask = mask.to(dev)
            for m in (mask, None):
                a = (qkv, bias, m, heads, k1.HEAD_DIM**-0.5)
                yield Case(
                    "window_attention",
                    f"stage{stage} qkv{tuple(qkv.shape)} H{heads} "
                    f"{'mask' if m is not None else 'nomask'} {_dtype_name(dt)}",
                    lambda a=a: k1.window_attention(*a),
                    lambda a=a: k1.window_attention_reference(*a),
                    _one(tol), args=a,
                    nbytes=_nbytes(qkv, bias, m) + qkv.numel() // 3 * qkv.element_size(),
                    flops=4 * qkv.shape[0] * 144 * 144 * c, matmul=True,
                )


def dyn_exp_step_cases(dev) -> Iterator[Case]:
    """B=24 rows (b8 x beam 3), E=16, d=512, L in {20, 74}, a non-identity
    reorder, pos in {0, 7, L-1}, fp32 and bf16 caches. Checks the output and
    all six destination caches."""
    b, E, d = 24, 16, 512
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        for L in (20, 74):
            g = torch.Generator().manual_seed(200 + L)
            src = [_randn((b, L, d), g, dev, dtype=dt) for _ in range(4)]
            src += [_randn((b, L, E, d), g, dev, dtype=dt) for _ in range(2)]
            reorder = torch.randint(0, b, (b,), generator=g, dtype=torch.int32)
            reorder[0] = 5  # non-identity for sure
            reorder = reorder.to(dev)
            q_i = _randn((b, E, d), g, dev, dtype=dt)
            bias_i = _randn((b, E, d), g, dev, dtype=dt)
            rows = [_randn((b, d), g, dev, dtype=dt) for _ in range(4)]
            sel = torch.sigmoid(_randn((b, d), g, dev))
            embed = _randn((E, d), g, dev, dtype=dt)
            dst = [torch.empty_like(t) for t in src]
            for pos in (0, 7, L - 1):
                a = (pos, reorder, q_i, bias_i, *rows, sel, embed, src)

                def run_kernel(a=a, dst=dst):
                    return k2.dyn_exp_step(*a, dst), dst

                def checks(got, want, tol=tol):
                    (out, new), (want_out, want_new) = got, want
                    pairs = [("out", out, want_out, tol)]
                    names = ("keys", "ca", "cb", "cond", "vals_a", "vals_b")
                    return pairs + [(n, g_, w_, tol) for n, g_, w_ in zip(names, new, want_new)]

                yield Case(
                    "dyn_exp_step", f"B{b} L{L} pos{pos} {_dtype_name(dt)}",
                    run_kernel, lambda a=a: k2.dyn_exp_step_reference(*a), checks, args=a,
                    # the step returns every position of the six caches
                    nbytes=2 * _nbytes(*src) + _nbytes(reorder, q_i, bias_i, *rows, sel, embed)
                    + b * d * 4,
                    flops=10 * b * (pos + 1) * E * d, matmul=True,
                )


def dyn_exp_cross_step_cases(dev) -> Iterator[Case]:
    """B16 at B=24 rows (8 images x 3 beams), S=144 encoder tokens, d=512, 8
    heads, E=16, L in {20, 74}, a non-identity reorder, a pad mask with 0 and
    16 pads, pos in {0, 7, L-1}, fp32 and bf16; and the 5 rows of one image
    (beam 5) at L=74. Checks the output row and all six destination caches."""
    E, d, heads, S = 16, 512, 8, 144
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        for b, group, L, positions in ((24, 3, 20, (0, 7, 19)), (24, 3, 74, (0, 7, 73)),
                                       (5, 5, 74, (7,))):
            g = torch.Generator().manual_seed(1000 + 10 * L + b)
            src = [_randn((b, L, d), g, dev, dtype=dt) for _ in range(4)]
            src += [_randn((b, L, E, d), g, dev, dtype=dt) for _ in range(2)]
            reorder = torch.randint(0, b, (b,), generator=g, dtype=torch.int32)
            reorder[0] = 4  # non-identity for sure
            reorder = reorder.to(dev)
            q_i = _randn((b, E, d), g, dev, dtype=dt)
            bias_i = _randn((b, E, d), g, dev, dtype=dt)
            rows = [_randn((b, d), g, dev, dtype=dt) for _ in range(4)]
            sel = torch.sigmoid(_randn((b, d), g, dev))
            embed = _randn((E, d), g, dev, dtype=dt)
            y = _randn((b, d), g, dev)
            ln2 = _norm(d, g, dev)
            (wq, bq), (wo, bo) = _linear(d, d, g, dev, dt), _linear(d, d, g, dev, dt)
            kc = _randn((b // group, S, d), g, dev, dtype=dt)
            vc = _randn((b // group, S, d), g, dev, dtype=dt)
            pads = torch.tensor([0, 16] * 4)[: b // group]
            mask = (torch.arange(S)[None, :] < (S - pads)[:, None]).float().to(dev)
            dst = [torch.empty_like(t) for t in src]
            kw = dict(heads=heads, ln_eps=1e-5, attn_fill=-1e4, group=group, eps=1e-9,
                      compute_dtype=dt)
            for pos in positions:
                a = (pos, reorder, q_i, bias_i, *rows, sel, embed, y, ln2, wq, bq, wo, bo,
                     kc, vc, mask, src)

                def run_kernel(a=a, dst=dst, kw=kw):
                    return k2.dyn_exp_cross_step(*a, dst, **kw), dst

                def checks(got, want, tol=tol):
                    (out, new), (want_out, want_new) = got, want
                    pairs = [("y_out", out, want_out, tol)]
                    names = ("keys", "ca", "cb", "cond", "vals_a", "vals_b")
                    return pairs + [(n, g_, w_, tol) for n, g_, w_ in zip(names, new, want_new)]

                yield Case(
                    "dyn_exp_cross_step", f"B{b} L{L} pos{pos} {_dtype_name(dt)}",
                    run_kernel, lambda a=a, kw=kw: k2.dyn_exp_cross_step_reference(*a, **kw),
                    checks, args=a,
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


def layernorm_cases(dev) -> Iterator[Case]:
    """Every LayerNorm width of the main path at its row count for B=2:
    Swin stages 0-3, the 4C patch-merge input, and the d512 captioner."""
    for c, rows in [(192, 18432), (384, 4608), (768, 1152), (1536, 288),
                    (3072, 288), (512, 288)]:
        g = torch.Generator().manual_seed(400 + c)
        w = _randn((c,), g, dev, scale=0.5) + 1.0
        bias = _randn((c,), g, dev, scale=0.5)
        for dt in (torch.float32, torch.bfloat16):
            x = _randn((rows, c), g, dev, scale=2.0, dtype=dt) + 0.5
            a = (x, w, bias)
            yield Case(
                "layernorm", f"({rows}, {c}) {_dtype_name(dt)}",
                lambda a=a: k4.layernorm(*a),
                lambda a=a: k4.layernorm_reference(*a),
                _one(TOL[dt]), args=a,
                nbytes=2 * _nbytes(x) + _nbytes(w, bias), flops=8 * x.numel(),
            )


def _norm(c, g, dev):
    return _randn((c,), g, dev, scale=0.2) + 1.0, _randn((c,), g, dev, scale=0.2)


def _linear(k, n, g, dev, dt, bias=True):
    """(in, out) weight of unit output variance and its fp32 bias."""
    return _randn((k, n), g, dev, scale=k**-0.5, dtype=dt), (
        _randn((n,), g, dev, scale=0.2) if bias else None)


def swin_block_cases(dev) -> Iterator[Case]:
    """B6 on the two stages that run it (C = 192 and 384) at B=2: block 0 (no
    mask, no transition) and block 1 (mask, transition 0 -> 6), fp32 and bf16."""
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
                yield Case(
                    "swin_block",
                    f"stage{stage} x{tuple(x.shape)} {'mask' if m is not None else 'nomask'} "
                    f"{name} {_dtype_name(dt)}",
                    lambda a=a: sbf.swin_block(*a),
                    lambda a=a: sbf.swin_block_reference(*a),
                    _one(TOL[dt]), args=a,
                    nbytes=2 * _nbytes(x)
                    + _nbytes(*norm1, *qkv, *proj, *norm2, *fc1, *fc2, bias, m),
                    flops=bw * N_TOKENS * (24 * c * c + 4 * N_TOKENS * c), matmul=True,
                )


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


def swin_mlp_half_cases(dev) -> Iterator[Case]:
    """B5 on the rows of the three multi-window stages at B=2, fp32 and bf16."""
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


def patch_embed_cases(dev) -> Iterator[Case]:
    """B7 at B=2: (2, 96, 96, 48) space-to-depth rows -> (128, 144, 192)."""
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(800)
        x = _randn((2, 96, 96, 48), g, dev, dtype=dt)
        proj, norm = _linear(48, 192, g, dev, dt), _norm(192, g, dev)
        a = (x, proj, norm, WINDOW, 1e-5)
        yield Case(
            "patch_embed", f"x{tuple(x.shape)} C192 {_dtype_name(dt)}",
            lambda a=a: sb.patch_embed_fused(*a),
            lambda a=a: sb.patch_embed_reference(*a),
            _one(TOL[dt]), args=a,
            nbytes=_nbytes(x, *proj, *norm) + x.numel() // 48 * 192 * x.element_size(),
            flops=2 * x.numel() * 192, matmul=True,
        )


def downsample_cases(dev) -> Iterator[Case]:
    """B8 at B=2 after each of the three multi-window stages."""
    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, _, res) in enumerate(STAGES[:3]):
            g = torch.Generator().manual_seed(900 + stage)
            x = _randn((2 * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=dt)
            norm, (w, _) = _norm(4 * c, g, dev), _linear(4 * c, 2 * c, g, dev, dt, bias=False)
            a = (x, norm, w, res // WINDOW, WINDOW, 1e-5)
            yield Case(
                "downsample", f"stage{stage} x{tuple(x.shape)} {_dtype_name(dt)}",
                lambda a=a: sb.downsample_fused(*a),
                lambda a=a: sb.downsample_reference(*a),
                _one(TOL[dt]), args=a,
                nbytes=_nbytes(x, *norm, w) + _nbytes(x) // 2,
                flops=x.numel() * 4 * c, matmul=True,
            )


def _rel_to_max(t):
    """Tolerance of a gradient against its plain version: t times the largest
    magnitude of the tensor. The sums over every row or window of the grid
    are atomic adds in another order each run, so single elements near zero
    are held to the size of the tensor, not to their own."""
    return lambda want: (t * float(want.float().abs().max()), 0.0)


# gradients, relative to each tensor's max: fp32 differs in summation order
# only; bf16 operands are rounded at the same places on both sides, and a
# flipped rounding upstream moves a sum by a fraction of a bf16 ulp of its terms
GRAD_TOL = {torch.float32: _rel_to_max(2e-5), torch.bfloat16: _rel_to_max(2e-2)}


def _scales(b, dev, zero_at):
    """(B,) fp32 stochastic-depth scales: 1 / keep with one image dropped."""
    m = torch.full((b,), 1.0 / 0.9)
    m[zero_at] = 0.0
    return m.to(dev)


def _named(names, tol_of):
    def checks(got, want):
        return [(n, g_, w_, tol_of(w_)) for n, g_, w_ in zip(names, got, want)]
    return checks


def _block_operands(stage, seed, dev, dt):
    c, heads, res = STAGES[stage]
    g = torch.Generator().manual_seed(seed + stage)
    bw = 2 * (res // WINDOW) ** 2
    x = _randn((bw, N_TOKENS, c), g, dev, dtype=dt)
    dy = _randn((bw, N_TOKENS, c), g, dev, dtype=dt)
    ops = dict(
        norm1=_norm(c, g, dev), qkv=_linear(c, 3 * c, g, dev, dt), proj=_linear(c, c, g, dev, dt),
        norm2=_norm(c, g, dev), fc1=_linear(c, 4 * c, g, dev, dt), fc2=_linear(4 * c, c, g, dev, dt),
        bias=_randn((heads, N_TOKENS, N_TOKENS), g, dev, scale=0.5),
        mask=torch.from_numpy(shift_attn_mask(res, WINDOW, SHIFT)).to(dev),
        m1=_scales(2, dev, 1), m2=_scales(2, dev, 0),
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


def swin_mlp_bwd_cases(dev) -> Iterator[Case]:
    """B9c on the rows of the three multi-window stages at B=2, one image
    dropped, one case without the fc1 bias; all seven gradients; fp32 and
    bf16."""
    names = ("dx2", "dg2", "dbe2", "dw1", "db1", "dw2", "db2")
    for dt in (torch.float32, torch.bfloat16):
        for stage in (0, 1, 2):
            x2, dy, o, _, _ = _block_operands(stage, 1500, dev, dt)
            c = x2.shape[-1]
            fc1 = o["fc1"] if stage else (o["fc1"][0], None)
            a = (x2, dy, o["norm2"], fc1, o["fc2"], o["m2"], 1e-5)
            yield Case(
                "swin_mlp_bwd", f"stage{stage} x{tuple(x2.shape)} {_dtype_name(dt)}",
                lambda a=a: sbf.swin_mlp_bwd(*a),
                lambda a=a: sbf.swin_mlp_bwd_reference(*a),
                _named(names, GRAD_TOL[dt]), args=a,
                # x2, dy in and dx2 out; the weights in and their fp32 gradients out
                nbytes=3 * _nbytes(x2) + _nbytes(*o["norm2"], *fc1, o["fc2"][0], o["m2"])
                + 4 * (8 * c * c + 7 * c),
                flops=x2.numel() * 40 * c, matmul=True,
            )


def swin_attn_bwd_cases(dev) -> Iterator[Case]:
    """B9b on the three multi-window stages at B=2, with and without the
    mask, one image dropped, one case without the qkv bias; all eight
    gradients (dbias among them); fp32 and bf16."""
    names = ("dx", "dg1", "dbe1", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    for dt in (torch.float32, torch.bfloat16):
        for stage in (0, 1, 2):
            x, dy, o, heads, scale = _block_operands(stage, 1600, dev, dt)
            c = x.shape[-1]
            for m in (o["mask"], None):
                qkv = o["qkv"] if m is not None else (o["qkv"][0], None)
                a = (x, dy, o["norm1"], qkv, o["proj"], o["bias"], m, o["m1"], heads, scale, 1e-5)
                yield Case(
                    "swin_attn_bwd",
                    f"stage{stage} x{tuple(x.shape)} {'mask' if m is not None else 'nomask'} "
                    f"{_dtype_name(dt)}",
                    lambda a=a: sbf.swin_attn_bwd(*a),
                    lambda a=a: sbf.swin_attn_bwd_reference(*a),
                    _named(names, GRAD_TOL[dt]), args=a,
                    # x, dx2 in and dx out; weights, bias and mask in; fp32 gradients out
                    nbytes=3 * _nbytes(x) + _nbytes(*o["norm1"], *qkv, o["proj"][0], o["bias"],
                                                    m, o["m1"])
                    + 4 * (4 * c * c + 6 * c) + _nbytes(o["bias"]),
                    flops=x.shape[0] * N_TOKENS * (22 * c * c + 12 * N_TOKENS * c), matmul=True,
                )


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
    1536 -> 6144), a decoder linear at 24 rows (512 -> 2048), the vocab linear
    (512 -> 10000, a ragged last column tile) and the patch embed (B = 2,
    18432 rows, 48 -> 192); the dynamic scale in fp32 and bf16, and one
    calibrated fp32 scale on bf16 x. The int8 x must equal the plain
    version's bit for bit; the output is within 1e-6 of its max (the int32
    sums are exact on both sides; fp32 roundings of the epilogue remain)."""
    shapes = [("stage3 fc1", 288, 1536, 6144), ("decode ff", 24, 512, 2048),
              ("vocab", 24, 512, VOCAB), ("patch embed", 18432, 48, 192)]
    runs = [(name, m, k, n, dt, False) for name, m, k, n in shapes
            for dt in (torch.float32, torch.bfloat16)]
    runs.append(("decode ff", 24, 512, 2048, torch.bfloat16, True))
    for name, m, k, n, dt, static in runs:
        g = torch.Generator().manual_seed(1700 + k + n)
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

        yield Case(
            "quant_matmul",
            f"{name} x({m}, {k}) N{n} {_dtype_name(dt)}{' static' if static else ''}",
            lambda run=run: run(qm.quantized_matmul),
            lambda run=run: run(qm.quantized_matmul_reference),
            checks, args=a,
            nbytes=_nbytes(x, w_q, scale, bias, x_scale) + 4 * m * n,
            flops=2 * m * n * k, int8=True,
            time_kernel=lambda a=a: qm.quantized_matmul(*a),
            time_plain=lambda a=a: qm.quantized_matmul_reference(*a),
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

    for dt in (torch.float32, torch.bfloat16):
        for stage, (c, _, res) in enumerate(STAGES[:3]):
            g = torch.Generator().manual_seed(1800 + stage)
            x = _randn((2 * (res // WINDOW) ** 2, N_TOKENS, c), g, dev, dtype=dt)
            norm2 = _norm(c, g, dev)
            fc1 = (*_int8_weight(4 * c, c, g, dev), _randn((4 * c,), g, dev, scale=0.2))
            fc2 = (*_int8_weight(c, 4 * c, g, dev), _randn((c,), g, dev, scale=0.2))
            a = (x, norm2, fc1, fc2, 1e-5)
            yield Case(
                "swin_mlp_half_a8", f"stage{stage} x{tuple(x.shape)} {_dtype_name(dt)}",
                lambda a=a: sbf.swin_mlp_half_a8(*a, hidden=True),
                lambda a=a: sbf.swin_mlp_half_a8_reference(*a, hidden=True),
                checks_of(dt), args=a,
                nbytes=2 * _nbytes(x) + _nbytes(*norm2, *fc1, *fc2),
                flops=x.numel() * 16 * c, int8=True,
                time_kernel=lambda a=a: sbf.swin_mlp_half_a8(*a),
                time_plain=lambda a=a: sbf.swin_mlp_half_a8_reference(*a),
            )


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
    "swin_mlp_half_a8": swin_mlp_half_a8_cases,
}


def compare(got: torch.Tensor, want: torch.Tensor, tol: Tuple[float, float]):
    """(max abs error, max rel error, ok) of got against want under
    |got - want| <= atol + rtol |want|. NaN matches NaN and an infinity
    matches the same infinity; anything else non-finite fails."""
    atol, rtol = tol
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return float("inf"), float("inf"), False
    if g.numel() == 0:
        return 0.0, 0.0, True
    special = (torch.isnan(g) & torch.isnan(w)) | (torch.isinf(g) & (g == w))
    finite = torch.isfinite(g) & torch.isfinite(w)
    diff = torch.where(special, 0.0, torch.where(finite, (g - w).abs(), float("inf")))
    w_abs = torch.where(finite, w.abs(), 0.0)
    rel = diff / w_abs.clamp_min(1e-6)
    ok = not bool((diff > atol + rtol * w_abs).any())
    return float(diff.max()), float(rel.max()), ok
