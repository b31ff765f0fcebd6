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
from typing import Callable, Iterator, List, Tuple

import torch

from ..models.swin import shift_attn_mask
from . import dyn_exp_step as k2
from . import layernorm as k4
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
