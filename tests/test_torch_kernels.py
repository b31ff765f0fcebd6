"""Card-only checks: each hand-written kernel against its plain PyTorch version
on CUDA tensors, at main-path shapes (Swin-L/384 windows on both backbone
paths, the d512 decoder, V = 10000), and the wrappers' refusal of CUDA shapes
their kernel does not take. Marked `cuda`; without a card they skip (decided inside the fixture).
This file imports no JAX, so it runs on a card machine with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The cases and their tolerances live in `ops/_cases.py`, which `chip_smoke.py`
checks too: fp32 2e-5 abs + 1e-4 rel (summation order only); bf16 2e-2 abs +
2e-2 rel (one bf16 ulp is 2^-8 relative); top-k values and indices exactly;
the int8 product's int8 x exactly and its output within 1e-6 of its max; the
int8 MLP half by int8 steps and rows (see `swin_mlp_half_a8_cases`); the
decode-step kernels K2 and B16, the whole-block kernels B6 and B9a, and the
shared bf16 product of B4 and B5 (alone, at ragged rows, stage 0's width,
the merge and the transition), K3 and K4, and B7 and B8 in every grid, tile
form and K split, also bit for bit from one launch to the next; K3 also in
every cluster size it takes; the window-attention core on each of its routes
(bf16 N = 144 on the tensor cores, fp32 and bf16 of other window sizes on the
CUDA cores) with both roundings (through K1 and through B4), bit for bit from
one launch to the next too.
"""
import pytest
import torch

from on_device_image_captioning_torch.ops import _cases
from on_device_image_captioning_torch.ops import dyn_exp_step as k2
from on_device_image_captioning_torch.ops import fused_linear as fl
from on_device_image_captioning_torch.ops import layernorm as k4
from on_device_image_captioning_torch.ops import quant_matmul as qm
from on_device_image_captioning_torch.ops import stage_boundary as sb
from on_device_image_captioning_torch.ops import swin_block_fused as sbf
from on_device_image_captioning_torch.ops import topk as k3
from on_device_image_captioning_torch.ops import window_attention as k1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these checks there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_cases.CASES))
def test_kernel_matches_plain_version(cuda, kernel):
    n_cases = 0
    for case in _cases.CASES[kernel](cuda):
        for part, got, want, tol in case.check():
            abs_err, rel_err, ok = _cases.compare(got, want, tol)
            assert ok, (f"{case.label} {part}: max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
                        f"over atol {tol[0]:g} + rtol {tol[1]:g}")
        n_cases += 1
    assert n_cases > 0


@pytest.mark.cuda
@pytest.mark.parametrize("width, k", [(512, 3), (10000, 9), (10000, 0)])
def test_topk_raises_outside_kernel_shapes(cuda, width, k):
    """K3 takes V >= 1024 and 1 <= k <= 8; on the card nothing else runs."""
    x = torch.randn((4, width), device=cuda)
    before = k3.launches
    with pytest.raises(ValueError):
        k3.topk(x, k)
    assert k3.launches == before


def _topk_rows(cuda, rows, v, seed, dtype=torch.float32):
    """Log-prob rows with planted ties, a row of dense ties, a row of fewer
    than 8 finite values and NaN rows (NaN at 0, at 2, past 8, last)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.log_softmax(torch.randn((rows, v), generator=g) * 3.0, dim=-1)
    x[:, 100] = x[:, 7]
    x[:, 900] = x.max(dim=1).values
    x[1] = torch.randn(3, generator=g)[torch.randint(0, 3, (v,), generator=g)]
    x[2] = -float("inf")
    x[2, 10], x[2, v - 1] = -1.0, -2.0
    for r, at in ((3, 0), (4, 2), (5, 1500), (6, v - 1)):
        if r < rows:
            x[r, at] = float("nan")
    return x.to(cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, 9))
def test_topk_every_cluster_size(cuda, k, dtype):
    """K3 in every cluster size it takes, on rows of V = 10001 (each row's
    first 16-byte boundary elsewhere: heads and tails of every length), equals
    the plain version exactly."""
    x = _topk_rows(cuda, 12, 10001, 600 + k, dtype)
    want_v, want_i = k3.topk_reference(x, k)
    for cluster in k3.CLUSTER_SIZES:
        got_v, got_i = k3.launch(x, k, k3.TopkPlan(cluster, 12 * cluster))
        torch.cuda.synchronize()
        assert torch.equal(got_i, want_i), f"cluster {cluster}"
        assert torch.equal(got_v.isnan(), want_v.isnan()), f"cluster {cluster}"
        assert torch.equal(got_v.nan_to_num(), want_v.nan_to_num()), f"cluster {cluster}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [
    ((24, 512), torch.float32), ((5, 512), torch.float32), ((73728, 192), torch.bfloat16)])
def test_layernorm_bit_for_bit(cuda, shape, dtype):
    """K4's sums run in an order fixed by the lane layout: two launches on
    the same inputs give the same bits (the decode's shapes and the
    "pallas" backbone's b8 stage 0)."""
    g = torch.Generator().manual_seed(70)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    w, b = (torch.randn(shape[-1:], generator=g).to(cuda) for _ in range(2))
    first = k4.layernorm(x, w, b)
    assert torch.equal(first, k4.layernorm(x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("rows, k", [(24, 3), (5, 5), (24, 8)])
def test_topk_bit_for_bit(cuda, rows, k):
    """K3 at the decode's shapes: two launches agree bit for bit."""
    x = _topk_rows(cuda, rows, 10000, 71)
    first = k3.topk(x, k)
    second = k3.topk(x, k)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [33, 64, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_other_widths(cuda, c, dtype):
    """Widths off the main path run the kernel (the any-width instance where
    a row is no whole number of 16-byte chunks, or x is not 16-byte aligned)
    and match the plain version."""
    g = torch.Generator().manual_seed(c)
    w, b = (torch.randn((c,), generator=g).to(cuda) for _ in range(2))
    flat = (torch.randn((77 * c + 1,), generator=g) * 2).to(cuda, dtype)
    for x in (flat[: 77 * c].view(77, c), flat[1:].view(77, c)):  # aligned, then not
        before = k4.launches
        got = k4.layernorm(x, w, b)
        assert k4.launches == before + 1
        abs_err, rel_err, ok = _cases.compare(got, k4.layernorm_reference(x, w, b),
                                              _cases.TOL[dtype])
        assert ok, f"max_abs {abs_err:.3e} max_rel {rel_err:.3e}"


@pytest.mark.cuda
def test_layernorm_raises_outside_its_operands(cuda):
    """On the card K4 launches or raises: fp32 weight and bias only, fp32 or
    bf16 x only, every operand on the same CUDA device; a layout the
    dispatcher has no kernel for is refused there."""
    x = torch.randn((4, 192), device=cuda)
    w, b = torch.ones(192, device=cuda), torch.zeros(192, device=cuda)
    before = k4.launches
    with pytest.raises(ValueError, match="float32"):
        k4.layernorm(x.bfloat16(), w.bfloat16(), b)
    with pytest.raises(ValueError, match="dtype"):
        k4.layernorm(x.half(), w, b)
    with pytest.raises(ValueError, match="operands on"):
        k4.layernorm(x, w.cpu(), b)
    with pytest.raises(NotImplementedError, match="SparseCUDA"):
        k4.layernorm(x.to_sparse(), w, b)
    assert k4.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [3, 12])
def test_window_attention_raises_on_other_head_widths(cuda, heads):
    """K1 is built for dk = 32 only (c = 192: 3 heads is dk 64, 12 is dk 16)."""
    qkv = torch.randn((4, 144, 576), device=cuda)
    bias = torch.zeros((heads, 144, 144), device=cuda)
    with pytest.raises(ValueError):
        k1.window_attention(qkv, bias, None, heads, 0.125)


# (windows, nW or None, heads, N, dtype) of the attention core's routes off
# the phase-3 cases: the tensor cores (bf16, N = 144) at plans of several
# heads a CTA, of image shares and of one (window, head) a CTA; the CUDA
# cores at fp32 and at bf16 windows of other sizes (a quad's keys past N, rows
# past N, N = 192 on the wide instance)
ATTN_ROUTES = [
    (128, 64, 6, 144, torch.bfloat16), (32, 4, 24, 144, torch.bfloat16),
    (24, 4, 24, 144, torch.bfloat16), (6, None, 48, 144, torch.bfloat16),
    (16, 16, 12, 144, torch.float32), (6, None, 24, 144, torch.float32),
    (12, 4, 3, 49, torch.bfloat16), (8, None, 2, 16, torch.bfloat16),
    (32, 16, 6, 64, torch.float32), (6, 3, 4, 100, torch.bfloat16),
    (4, 2, 6, 192, torch.float32), (4, 2, 6, 192, torch.bfloat16), (3, None, 1, 7, torch.float32),
]
ATTN_IDS = [f"bw{bw}-nw{nw}-h{h}-n{n}-{str(dt)[6:]}" for bw, nw, h, n, dt in ATTN_ROUTES]


def _attn_operands(cuda, bw, nw, heads, n, dt, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = (torch.randn((bw, n, 3 * heads * k1.HEAD_DIM), generator=g)).to(cuda, dt)
    bias = (torch.randn((heads, n, n), generator=g) * 0.5).to(cuda)
    mask = None
    if nw is not None:
        mask = torch.where(torch.rand((nw, n, n), generator=g) > 0.7, -100.0, 0.0).to(cuda)
    return qkv, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("bw, nw, heads, n, dt", ATTN_ROUTES, ids=ATTN_IDS)
def test_attention_core_routes_match_plain_version(cuda, bw, nw, heads, n, dt):
    """K1 (window_attention_pallas's rounding) on each route and plan against
    its plain version, and two launches bit-equal (every sum in a fixed
    order)."""
    a = (*_attn_operands(cuda, bw, nw, heads, n, dt, 4100 + n), heads, k1.HEAD_DIM**-0.5)
    got = k1.window_attention(*a)
    abs_err, rel_err, ok = _cases.compare(got, k1.window_attention_reference(*a), _cases.TOL[dt])
    assert ok, f"max_abs {abs_err:.3e} max_rel {rel_err:.3e}"
    again = k1.window_attention(*a)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n, dt", [(144, torch.bfloat16), (144, torch.float32),
                                   (49, torch.bfloat16), (49, torch.float32)])
def test_attention_core_fused_rounding_through_b4(cuda, n, dt):
    """The core with the fused kernels' rounding (q scaled in the storage
    type, exp(s - max) rounded before the product with v, the division after
    it) inside B4, on both routes, against B4's plain version; bit-equal from
    one launch to the next."""
    g = torch.Generator().manual_seed(4200 + n)
    bw, c, heads = 8, 192, 6
    x = (torch.randn((bw, n, c), generator=g)).to(cuda, dt)
    norm = (torch.ones(c, device=cuda), torch.zeros(c, device=cuda))
    qkv = ((torch.randn((c, 3 * c), generator=g) * c**-0.5).to(cuda, dt),
           torch.randn((3 * c,), generator=g).to(cuda))
    proj = ((torch.randn((c, c), generator=g) * c**-0.5).to(cuda, dt),
            torch.randn((c,), generator=g).to(cuda))
    bias = (torch.randn((heads, n, n), generator=g) * 0.5).to(cuda)
    mask = torch.where(torch.rand((4, n, n), generator=g) > 0.7, -100.0, 0.0).to(cuda)
    a = (x, norm, qkv, proj, bias, mask, heads, k1.HEAD_DIM**-0.5, 1e-5)
    got = sbf.swin_attn_half(*a)
    abs_err, rel_err, ok = _cases.compare(got, sbf.swin_attn_half_reference(*a), _cases.TOL[dt])
    assert ok, f"max_abs {abs_err:.3e} max_rel {rel_err:.3e}"
    again = sbf.swin_attn_half(*a)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_window_attention_raises_outside_its_operands(cuda):
    """Windows of more than 192 tokens, and operands not 16-byte aligned,
    get a raise, not a launch."""
    before = k1.launches
    qkv, bias, _ = _attn_operands(cuda, 2, None, 2, 193, torch.float32, 1)
    with pytest.raises(ValueError, match="tokens"):
        k1.window_attention(qkv, bias, None, 2, 0.125)
    qkv, bias, _ = _attn_operands(cuda, 2, None, 2, 144, torch.bfloat16, 1)
    shifted = torch.empty(qkv.numel() + 1, dtype=qkv.dtype, device=cuda)[1:].view(qkv.shape)
    shifted.copy_(qkv)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k1.window_attention(shifted, bias, None, 2, 0.125)
    assert k1.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["k1_rounding", "fused_rounding"])
def test_attention_core_resources_match_ptxas(cuda, fused):
    """Every instance of the attention core, in K1's library and in the
    attention half's (the fused rounding), has the registers and the local
    memory (spills) a thread that the plan and PERF.md state
    (ops/window_attention.py REGISTERS and LOCAL_BYTES, ptxas's figures)."""
    want = [(route, dtype, k1.REGISTERS[route], local)
            for (route, dtype), local in zip(k1.INSTANCES, k1.LOCAL_BYTES[fused])]
    assert k1.kernel_resources(fused) == want


@pytest.mark.cuda
def test_window_resident_kernels_raise_outside_their_shapes(cuda):
    """On the card the window-resident wrappers launch their kernel or raise:
    B4 is built for dk = 32, B7 holds output rows of at most 192, B11 copies
    rows in 16-byte chunks, and weights must come in the activations' dtype."""
    ones = lambda *shape: torch.ones(shape, device=cuda)  # noqa: E731
    norm = lambda c: (ones(c), ones(c))  # noqa: E731
    x = torch.randn((4, 144, 192), device=cuda)
    before = (sbf.attn_half_launches, sbf.mlp_half_launches, sbf.transition_launches,
              sb.patch_embed_launches, sb.downsample_launches)
    with pytest.raises(ValueError, match="head width"):
        sbf.swin_attn_half(x, norm(192), (ones(192, 576), None), (ones(192, 192), None),
                           ones(3, 144, 144), None, 3, 0.125, 1e-5)
    with pytest.raises(ValueError, match="weights must be"):
        sbf.swin_mlp_half(x.bfloat16(), norm(192), (ones(192, 768), None),
                          (ones(768, 192), None), 1e-5)
    with pytest.raises(ValueError, match="16-byte rows"):
        sbf.window_transition(torch.randn((4, 144, 2), device=cuda), 24, 12, 6, 0)
    with pytest.raises(ValueError, match="C <= 192"):
        sb.patch_embed_fused(torch.randn((1, 12, 12, 48), device=cuda),
                             (ones(48, 256), ones(256)), norm(256), 12, 1e-5)
    with pytest.raises(ValueError, match="w_in even"):
        sb.downsample_fused(torch.randn((9, 144, 192), device=cuda), norm(768),
                            ones(768, 384), 3, 12, 1e-5)
    assert before == (sbf.attn_half_launches, sbf.mlp_half_launches, sbf.transition_launches,
                      sb.patch_embed_launches, sb.downsample_launches)


@pytest.mark.cuda
def test_swin_block_raises_outside_its_shapes(cuda):
    """B6 is built for windows of 144 tokens, heads of 32 and C = 192 or 384;
    on the card the wrapper launches it or raises."""
    ones = lambda *shape: torch.ones(shape, device=cuda)  # noqa: E731
    norm = lambda c: (ones(c), ones(c))  # noqa: E731

    def block(x, c, heads, hidden=None, n=144, dtype=torch.float32):
        hidden = hidden or 4 * c
        lin = lambda k, m: (ones(k, m).to(dtype), None)  # noqa: E731
        return sbf.swin_block(x, norm(c), lin(c, 3 * c), lin(c, c), norm(c), lin(c, hidden),
                              lin(hidden, c), ones(heads, n, n), None, heads, 0.125, 1e-5)

    before = sbf.block_launches
    with pytest.raises(ValueError, match="C in"):  # stage 2 runs the halves
        block(torch.randn((4, 144, 768), device=cuda), 768, 24)
    with pytest.raises(ValueError, match="144 tokens"):
        block(torch.randn((4, 16, 192), device=cuda), 192, 6, n=16)
    with pytest.raises(ValueError, match="head width"):
        block(torch.randn((4, 144, 192), device=cuda), 192, 3)
    with pytest.raises(ValueError, match="multiple of 96"):
        block(torch.randn((4, 144, 192), device=cuda), 192, 6, hidden=800)
    with pytest.raises(ValueError, match="weights must be"):
        block(torch.randn((4, 144, 192), device=cuda).bfloat16(), 192, 6)
    assert sbf.block_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b, stage", [(1, 1), (8, 0)])
def test_whole_block_launches_repeat_bit_for_bit(cuda, b, stage):
    """B6 and B9a add fc2's partial sums over the cluster in rank order (no
    floating-point atomics): two launches on the same inputs give the same
    bits, at b1 stage 1 (8 CTAs a window) and b8 stage 0 (3)."""
    case = next(c for c in _cases.swin_block_cases(cuda)
                if c.label.startswith(f"b{b} stage{stage} "))
    first = case.run_kernel().clone()
    assert torch.equal(first, case.run_kernel())
    x, _, o, heads, scale = _cases._block_operands(stage, 1260, cuda, torch.bfloat16, b=b)
    a = (x, o["norm1"], o["qkv"], o["proj"], o["norm2"], o["fc1"], o["fc2"], o["bias"],
         o["mask"], o["m1"], o["m2"], heads, scale, 1e-5)
    first = [t.clone() for t in sbf.swin_block_train_forward(*a)]
    again = sbf.swin_block_train_forward(*a)
    torch.cuda.synchronize()
    assert all(torch.equal(f, g) for f, g in zip(first, again))


@pytest.mark.cuda
def test_block_plan_cluster_slots_are_the_cards(cuda):
    """ops/block_plan.py's CLUSTER_SLOTS is what the card reports for B6's
    clusters (checked on a 132-SM card, the one the table was read on)."""
    from on_device_image_captioning_torch.ops import block_plan as bp

    if torch.cuda.get_device_properties(cuda).multi_processor_count != bp.H100_SMS:
        pytest.skip("CLUSTER_SLOTS was read on a 132-SM H100")
    got = {k: bp.card_cluster_slots(384, k, 200000) for k in bp.CLUSTER_SLOTS}
    assert got == bp.CLUSTER_SLOTS


@pytest.mark.cuda
def test_dyn_exp_cross_step_raises_outside_its_shapes(cuda):
    """B16 takes compute dtype == cache dtype, fp32 pad masks, one K/V row per
    group of rows, and distinct source and destination caches."""
    case = next(c for c in _cases.dyn_exp_cross_step_cases(cuda) if "B5" in c.label)
    (pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, y, ln2, wq, bq, wo, bo,
     kc, vc, mask, src) = case.args
    dst = [torch.empty_like(t) for t in src]
    kw = dict(heads=8, ln_eps=1e-5, attn_fill=-1e4, group=5, eps=1e-9,
              compute_dtype=torch.float32)

    def step(**over):
        a = dict(wq=wq, mask=mask, dst=dst, kw=kw)
        a.update(over)
        return k2.dyn_exp_cross_step(
            pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, y, ln2, a["wq"],
            bq, wo, bo, kc, vc, a["mask"], src, a["dst"], **a["kw"])

    before = k2.cross_launches
    with pytest.raises(ValueError, match="compute dtype == cache dtype"):
        step(kw=dict(kw, compute_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="enc_mask must be fp32"):
        step(mask=mask > 0)
    with pytest.raises(ValueError, match="groups of"):
        step(kw=dict(kw, group=2))
    with pytest.raises(ValueError, match="wq, wo must be"):
        step(wq=wq.bfloat16())
    with pytest.raises(ValueError, match="alias"):
        step(dst=list(src))
    assert k2.cross_launches == before
    assert step().shape == (5, 512) and k2.cross_launches == before + 1


@pytest.mark.cuda
def test_training_kernels_raise_outside_their_shapes(cuda):
    """On the card the training wrappers launch their kernel or raise: B9a is
    built for C = 192 or 384, scales are per image in fp32, the backwards take
    a gradient of x's own type and weights in it."""
    case = next(c for c in _cases.swin_block_train_cases(cuda) if "stage0" in c.label)
    x, norm1, qkv, proj, norm2, fc1, fc2, bias, mask, m1, m2, heads, scale, eps = case.args
    before = (sbf.block_train_launches, sbf.attn_half_train_launches,
              sbf.mlp_half_train_launches, sbf.attn_bwd_launches, sbf.mlp_bwd_launches)
    wide = next(c for c in _cases.swin_attn_half_train_cases(cuda) if "stage2" in c.label).args
    with pytest.raises(ValueError, match="C in"):  # stage 2 runs the halves
        sbf.swin_block_train_forward(wide[0], wide[1], wide[2], wide[3], wide[1], wide[2],
                                     wide[3], wide[4], None, m1, m2, 24, scale, eps)
    with pytest.raises(ValueError, match="per image"):
        sbf.swin_block_train_forward(x, norm1, qkv, proj, norm2, fc1, fc2, bias, mask,
                                     torch.ones(3, device=cuda), m2, heads, scale, eps)
    with pytest.raises(ValueError, match="fp32"):
        sbf.swin_mlp_half_train_forward(x, norm2, fc1, fc2, m2.double(), eps)
    with pytest.raises(ValueError, match="weights must be"):
        sbf.swin_attn_half_train_forward(x.bfloat16(), norm1, qkv, proj, bias, mask, m1, heads,
                                         scale, eps)
    with pytest.raises(ValueError, match="shape and dtype"):
        sbf.swin_mlp_bwd(x, x.bfloat16(), norm2, fc1, fc2, m2, eps)
    with pytest.raises(ValueError, match="shape and dtype"):
        sbf.swin_attn_bwd(x, x[:2], norm1, qkv, proj, bias, mask, m1, heads, scale, eps)
    assert before == (sbf.block_train_launches, sbf.attn_half_train_launches,
                      sbf.mlp_half_train_launches, sbf.attn_bwd_launches, sbf.mlp_bwd_launches)


@pytest.mark.cuda
def test_training_functions_backward_on_the_card(cuda):
    """The autograd functions on CUDA tensors: fp32 master weights in, bf16
    compute, gradients in each parameter's dtype, launched through B9a and
    then B9c and B9b; the transition's gradient is the inverse transition."""
    case = next(c for c in _cases.swin_block_train_cases(cuda)
                if "stage0" in c.label and "bfloat16" in c.label)
    x, norm1, qkv, proj, norm2, fc1, fc2, bias, mask, m1, m2, heads, scale, eps = case.args
    master = lambda lin: (lin[0].float().requires_grad_(), lin[1].clone().requires_grad_())  # noqa: E731
    lins = [master(l) for l in (qkv, proj, fc1, fc2)]
    xg = x.clone().requires_grad_()
    before = (sbf.block_train_launches, sbf.mlp_bwd_launches, sbf.attn_bwd_launches)
    y = sbf.swin_block_train(xg, norm1, lins[0], lins[1], norm2, lins[2], lins[3], bias, mask,
                             m1, m2, heads, scale, eps)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    assert (sbf.block_train_launches, sbf.mlp_bwd_launches, sbf.attn_bwd_launches) == tuple(
        n + 1 for n in before)
    assert xg.grad.dtype == torch.bfloat16 and bool(torch.isfinite(xg.grad).all())
    for w, b in lins:
        assert w.grad.dtype == torch.float32 and w.grad.shape == w.shape
        assert bool(torch.isfinite(w.grad).all()) and bool(torch.isfinite(b.grad).all())
    t = sbf.window_transition_train(xg, 96, 12, 0, 6)
    (g,) = torch.autograd.grad(t, xg, x)
    torch.testing.assert_close(g, sbf.window_transition_reference(x, 96, 12, 6, 0), rtol=0, atol=0)


@pytest.mark.cuda
def test_int8_kernels_raise_outside_their_shapes(cuda):
    """B12 takes fp32 / bf16 x, int8 (N, K) weights with K a multiple of 16
    and fp32 scales; B13 int8 weights (4C, C) and (C, 4C) with fp32 scales.
    On the card the wrappers launch their kernel or raise."""
    x = torch.randn((24, 40), device=cuda)
    w_q = torch.ones((64, 40), dtype=torch.int8, device=cuda)
    scale = torch.ones(64, device=cuda)
    before = (qm.launches, sbf.mlp_half_a8_launches)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.quantized_matmul(x, w_q, scale)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        qm.quantized_matmul(x.double()[:, :32], w_q[:, :32].contiguous(), scale)
    with pytest.raises(ValueError, match="w_scale"):
        qm.quantized_matmul(x[:, :32].contiguous(), w_q[:, :32].contiguous(), scale.bfloat16())
    case = next(c for c in _cases.swin_mlp_half_a8_cases(cuda) if "stage0" in c.label)
    xa, norm2, fc1, fc2, eps = case.args
    with pytest.raises(ValueError, match="int8"):
        sbf.swin_mlp_half_a8(xa, norm2, (fc1[0].float(), *fc1[1:]), fc2, eps)
    with pytest.raises(ValueError, match="scales"):
        sbf.swin_mlp_half_a8(xa, norm2, fc1, (fc2[0], fc2[1].bfloat16(), fc2[2]), eps)
    with pytest.raises(ValueError, match="xq_out"):
        qm.quantized_matmul(x[:, :32].contiguous(), w_q[:, :32].contiguous(), scale,
                            xq_out=torch.empty((24, 32), device=cuda))
    with pytest.raises(ValueError, match="no rows"):
        qm.quantized_matmul(x[:0, :32], w_q[:, :32].contiguous(), scale)
    with pytest.raises(ValueError, match="x_scale"):
        qm.quantized_matmul(x[:, :32].contiguous(), w_q[:, :32].contiguous(), scale,
                            x_scale=torch.ones(2, device=cuda))
    assert before == (qm.launches, sbf.mlp_half_a8_launches)
    quantized = qm.quantize_launches
    out = qm.quantized_matmul(x[:, :32].contiguous(), w_q[:, :32].contiguous(), scale)
    assert out.dtype == torch.float32 and out.shape == (24, 64) and qm.launches == before[0] + 1
    assert qm.quantize_launches == quantized + 1


@pytest.mark.cuda
def test_int8_mlp_half_raises_outside_its_shapes(cuda):
    """B13 takes int8 weights (4C, C) and (C, 4C) with C and the hidden width
    multiples of 16 (16-byte int8 chunks); on the card it launches or raises."""
    case = next(c for c in _cases.swin_mlp_half_a8_cases(cuda) if "stage0" in c.label)
    x, norm2, fc1, fc2, eps = case.args
    before = sbf.mlp_half_a8_launches
    with pytest.raises(ValueError, match="int8"):
        sbf.swin_mlp_half_a8(x, norm2, (fc1[0].to(torch.bfloat16), *fc1[1:]), fc2, eps)
    with pytest.raises(ValueError, match="int8"):
        sbf.swin_mlp_half_a8(x, norm2, fc1, (fc2[0].float(), *fc2[1:]), eps)
    narrow = x[..., :184].contiguous()  # C = 184: not a multiple of 16
    norm = (norm2[0][:184].contiguous(), norm2[1][:184].contiguous())
    w1 = (fc1[0][:736, :184].contiguous(), fc1[1][:736].contiguous(), fc1[2][:736].contiguous())
    w2 = (fc2[0][:184, :736].contiguous(), fc2[1][:184].contiguous(), fc2[2][:184].contiguous())
    with pytest.raises(ValueError, match="multiples of 16"):
        sbf.swin_mlp_half_a8(narrow, norm, w1, w2, eps)
    w1 = (fc1[0][:760].contiguous(), fc1[1][:760].contiguous(), fc1[2][:760].contiguous())
    w2 = (fc2[0][:, :760].contiguous(), fc2[1], fc2[2])  # hidden 760: not a multiple of 16
    with pytest.raises(ValueError, match="multiples of 16"):
        sbf.swin_mlp_half_a8(x, norm2, w1, w2, eps)
    assert sbf.mlp_half_a8_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["b8 stage0 ", "b1 stage2 "])
def test_int8_mlp_half_launches_repeat_bit_for_bit(cuda, label):
    """B13 sums every output in one CTA in a fixed order (K is not split) and
    its only atomic is the max on the bits of non-negative floats: two
    launches on the same inputs give the same bits, outputs and int8 rows."""
    case = next(c for c in _cases.swin_mlp_half_a8_cases(cuda) if c.label.startswith(label))
    first = [t.clone() for t in case.run_kernel()]
    again = case.run_kernel()
    torch.cuda.synchronize()
    assert all(torch.equal(f, g) for f, g in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["stage0 ", "b1 stage2 "])
def test_int8_mlp_half_hidden_is_what_fc2_read(cuda, label):
    """hidden=True returns the kernel's own int8 buffers: fc1 alone on LN2's
    int8 rows gives the row absmaxes, and its GELU output quantized by them
    (IEEE division, as the kernel) the hidden, bit for bit; fc2 alone on that
    hidden gives the half's output bit for bit (same forms, same sums)."""
    case = next(c for c in _cases.swin_mlp_half_a8_cases(cuda) if c.label.startswith(label))
    x, norm2, fc1, fc2, eps = case.args
    out, xq, xs, hq, hmax = sbf._launch_mlp_half_a8(x, norm2, fc1, fc2, eps)
    _, want_xq, want_hq = sbf.swin_mlp_half_a8(x, norm2, fc1, fc2, eps, hidden=True)
    assert torch.equal(xq, want_xq) and torch.equal(hq, want_hq)
    gelu, amax = sbf.mlp_a8_product(xq, xs, fc1)
    assert torch.equal(amax, hmax)
    assert torch.equal(qm.quantize(gelu, sbf._amax_scales(hmax)), hq)
    c = x.shape[-1]
    got = sbf.mlp_a8_product(hq, hmax, fc2, resid=x.reshape(-1, c))
    assert torch.equal(got, out.reshape(-1, c))


@pytest.mark.cuda
@pytest.mark.parametrize("m, c", [(200, 192), (576, 768), (4608, 384)])
@pytest.mark.parametrize("form", [None, 0, 1, 2])
def test_int8_products_alone_in_every_form(cuda, m, c, form):
    """B13's products alone (`mlp_a8_product`) in each int8 form against their
    plain versions on the card: K = 192 (a slab and a half), N = 192 and 200
    rows (a ragged row tile). fc2's output bit for bit (int32 sums are exact
    and the epilogue rounds as the plain version does); fc1's fp32 GELU and
    its row absmaxes within 1e-6 of their max (erff against torch's erf)."""
    g = torch.Generator().manual_seed(m + c)
    ri = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, generator=g, dtype=torch.int8).to(cuda)
    for k, n, fc2 in ((c, 4 * c, False), (4 * c, c, True)):
        a_q, w_q = ri(m, k), ri(n, k)
        lin = (w_q, ((torch.rand(n, generator=g) + 0.5) * (k ** -0.5 / 73.0)).to(cuda),
               (torch.randn(n, generator=g) * 0.2).to(cuda))
        if fc2:
            a_scale = (torch.rand(m, generator=g) + 1.0).to(cuda)
            resid = torch.randn((m, n), generator=g).to(cuda, torch.bfloat16)
        else:
            a_scale, resid = ((torch.rand(m, generator=g) + 0.5) / 127.0).to(cuda), None
        before = sbf.mlp_a8_product_launches
        got = sbf.mlp_a8_product(a_q, a_scale, lin, resid, form=form)
        want = sbf.mlp_a8_product_reference(a_q, a_scale, lin, resid)
        assert sbf.mlp_a8_product_launches == before + 1
        if fc2:
            assert torch.equal(got, want)
        else:
            for part, w in zip(got, want):
                abs_err, _, ok = _cases.compare(part, w, _cases._within_max(1e-6)(w))
                assert ok, f"fc1 ({m}, {k}) -> {n} form {form}: {abs_err:.3e}"


@pytest.mark.cuda
def test_whole_block_first_seed_case_within_addend_ulps(cuda):
    """The b8 stage-1 B6 case drawn from the first seed base (1221), whose
    output adds x1 and the MLP branch where they nearly cancel, holds under
    the bf16 bound of ops/_cases.py: TOL plus one bf16 ulp of each addend."""
    case = next(c for c in _cases.swin_block_cases(cuda) if c.label.startswith("seed1221 "))
    for part, got, want, tol in case.check():
        abs_err, rel_err, ok = _cases.compare(got, want, tol)
        assert len(tol) == 3 and ok, (f"{case.label} {part}: max_abs {abs_err:.3e}, "
                                      f"{_cases.slack_used(got, want, tol)} in the slack")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [63, 64, 65, 66])
@pytest.mark.parametrize("k, n", [(48, 192), (512, _cases.VOCAB), (2080, 512)])
@pytest.mark.parametrize("dtype, static", [(torch.float32, False), (torch.bfloat16, False),
                                           (torch.bfloat16, True)])
def test_quant_matmul_both_routes(cuda, m, k, n, dtype, static):
    """B12 on both sides of its route boundary (small M up to 64 rows, large
    above): the patch embed's K = 48 (one slab, zero-filled), the vocab's
    ragged N = 10000 and a K = 2080 split into slices; the int8 x bit for bit,
    the output within 1e-6 of its max; one product launch and the scale /
    int8 x launches `quantize_launch_count` names."""
    case = _cases._quant_matmul_case(cuda, "boundary", m, k, n, dtype, static, seed=m + k)
    before = (qm.launches, qm.quantize_launches)
    for part, got, want, tol in case.check():
        abs_err, rel_err, ok = _cases.compare(got, want, tol)
        assert ok, f"{case.label} {part}: max_abs {abs_err:.3e} over atol {tol[0]:g}"
    assert qm.launches == before[0] + 1
    assert qm.quantize_launches == before[1] + qm.quantize_launch_count(m * k, static)
    assert qm.product_plan(m, n, k).route == ("small" if m <= 64 else "large")


@pytest.mark.cuda
@pytest.mark.parametrize("images", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_transition_exact_at_ragged_row_counts(cuda, images, dtype):
    """B11 at the three multi-window stages of Swin-L/384, both directions,
    on batches whose row count is not a multiple of the rows a CTA moves at
    a time: equal to the plain version, every value."""
    ragged = 0
    for stage, (c, _, res) in enumerate(_cases.STAGES[:3]):
        x = torch.randn((images * (res // 12) ** 2, 144, c), device=cuda).to(dtype)
        rows = x.shape[0] * 144
        per_cta = sbf.TRANSITION_WARPS * sbf.transition_group_rows(c * x.element_size())
        ragged += rows % per_cta != 0
        for f, t in ((6, 0), (0, 6)):
            got = sbf.window_transition(x, res, 12, f, t)
            assert torch.equal(got, sbf.window_transition_reference(x, res, 12, f, t)), (stage, f, t)
    assert ragged > 0


def _step_case(cuda, kernel, label):
    return next(c for c in _cases.CASES[kernel](cuda) if c.label == label)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dyn_exp_step", "dyn_exp_cross_step"])
@pytest.mark.parametrize("label", ["B5 L74 pos73 bfloat16", "B5 L74 pos36 float32",
                                   "B24 L20 pos7 bfloat16", "B40 L20 pos19 float32",
                                   "B12 L74 pos73 bfloat16"])
def test_decode_step_launches_repeat_bit_for_bit(cuda, kernel, label):
    """K2 and B16 sum their partial products in a fixed order (no
    floating-point atomics): two launches on the same inputs give the same
    bits in the output and in all six destination caches."""
    case = _step_case(cuda, kernel, label)
    out1, caches1 = case.run_kernel()
    out1, caches1 = out1.clone(), [t.clone() for t in caches1]
    out2, caches2 = case.run_kernel()
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)
    for a, b in zip(caches1, caches2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_decode_step_raises_outside_its_shapes(cuda):
    """K2 and B16 take d in 8 column slices of whole 16-byte chunks, B16
    heads a multiple of the cluster's 8 CTAs, and destination caches that
    share no byte with the sources; on the card nothing else launches."""
    case = _step_case(cuda, "dyn_exp_cross_step", "B5 L74 pos7 bfloat16")
    (pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, y, ln2, wq, bq, wo, bo,
     kc, vc, mask, src) = case.args
    kw = dict(heads=8, ln_eps=1e-5, attn_fill=-1e4, group=5, eps=1e-9,
              compute_dtype=torch.bfloat16)
    before = (k2.launches, k2.cross_launches)
    # d = 520: not 8 slices of 16-byte chunks
    wide = lambda t: torch.nn.functional.pad(t, (0, 8)).contiguous()  # noqa: E731
    srcw = [wide(t) for t in src]
    with pytest.raises(ValueError, match="column slices"):
        k2.dyn_exp_step(pos, reorder, wide(q_i), wide(bias_i), wide(k_i), wide(ca_i),
                        wide(cb_i), wide(cond_i), wide(sel), wide(embed), srcw,
                        [torch.empty_like(t) for t in srcw])
    dst = [torch.empty_like(t) for t in src]
    with pytest.raises(ValueError, match="heads"):
        k2.dyn_exp_cross_step(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
                              y, ln2, wq, bq, wo, bo, kc, vc, mask, src, dst,
                              **dict(kw, heads=4))
    # a destination that is a view into the source's bytes, starting elsewhere
    big = torch.empty(2 * src[4].numel(), dtype=src[4].dtype, device=cuda)
    src_v = list(src)
    src_v[4] = big[: src[4].numel()].view(src[4].shape)
    dst_v = list(dst)
    dst_v[4] = big[src[4].numel() // 2:][: src[4].numel()].view(src[4].shape)
    with pytest.raises(ValueError, match="alias"):
        k2.dyn_exp_step(pos, reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed,
                        src_v, dst_v)
    assert (k2.launches, k2.cross_launches) == before


# -- the shared bf16 product of B4 and B5 alone (ops/fused_linear.py) --------

def _product_operands(cuda, rows, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    rn = lambda shape, scale=1.0: (torch.randn(shape, generator=g) * scale).to(cuda)  # noqa: E731
    a = rn((rows, k)).to(torch.bfloat16)
    w = rn((k, n), k ** -0.5).to(torch.bfloat16)
    norm = (rn((k,), 0.2) + 1.0, rn((k,), 0.2))
    return a, w, rn((n,), 0.2), norm


def _hold_product(*args, **kw):
    """The kernel against its plain version on the same CUDA tensors (bf16
    tolerance of ops/_cases.py), and its launch counted once."""
    before = fl.launches
    got = fl.fused_linear(*args, **kw)
    want = fl.fused_linear_reference(*args, **kw)
    assert fl.launches == before + 1
    abs_err, rel_err, ok = _cases.compare(got, want, _cases.TOL[torch.bfloat16])
    assert ok, f"max_abs {abs_err:.3e} max_rel {rel_err:.3e}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [577, 1153, 576 + 16])
@pytest.mark.parametrize("k, n", [(768, 2304), (3072, 768), (96, 24)])
def test_shared_product_at_ragged_rows(cuda, rows, k, n):
    """Row counts that leave the last row tile partial (b1's stage 2 is 576
    rows): LayerNorm prologue and GELU where K is the width, the residual
    where it is 4 C; K 96 takes the form with slabs of 32, N 24 a partial
    column tile."""
    a, w, b, norm = _product_operands(cuda, rows, k, n, rows + k)
    if k == 3072:
        _hold_product(a, w, b, resid=_product_operands(cuda, rows, n, n, 1)[0])
    else:
        _hold_product(a, w, b, norm, gelu=True)


@pytest.mark.cuda
def test_shared_product_stage0_width_with_layernorm(cuda):
    """Stage 0's K = 192 (three slabs) with the LayerNorm prologue, at b1's
    9216 rows, qkv's N 576."""
    a, w, b, norm = _product_operands(cuda, 9216, 192, 576, 192)
    _hold_product(a, w, b, norm)


@pytest.mark.cuda
@pytest.mark.parametrize("c, res", [(192, 96), (384, 48), (768, 24)])
def test_shared_product_merges_four_segments(cuda, c, res):
    """The downsample's product: output rows gathered as four rows of C side
    by side along K (segs = 4) through the 2x2 merge, with the LayerNorm over
    4 C."""
    a, w, _, norm = _product_operands(cuda, 2 * res * res, c, 2 * c, c)
    w = _product_operands(cuda, 1, 4 * c, 2 * c, c + 1)[1]
    norm = _product_operands(cuda, 1, 4 * c, 1, c + 2)[3]
    _hold_product(a, w, None, norm, m=2 * res * res // 4, gather=("merge", res, 12, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("gathered", [False, True])
def test_shared_product_residual_through_transition_with_row_scale(cuda, gathered):
    """B4's proj epilogue: the residual read where the window transition
    0 -> 6 puts each row (stage 2 at b2), each image's rounded product scaled
    first (the training forwards' stochastic depth); with gathered=True the
    A rows go through the same transition (a gathered product without the
    LayerNorm)."""
    res, rows = 24, 2 * 24 * 24
    a, w, b, _ = _product_operands(cuda, rows, 768, 768, 24)
    x = _product_operands(cuda, rows, 768, 8, 25)[0]
    scale = torch.tensor([0.0, 1.25], device=cuda)
    trans = ("transition", res, 12, 6)
    _hold_product(a, w, b, gather=trans if gathered else None, resid=x, resid_gather=trans,
                  row_scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, k, n", [(4608, 768, 2304), (576, 3072, 768), (577, 96, 24)])
def test_shared_product_launches_repeat_bit_for_bit(cuda, rows, k, n):
    """K is not split there, and each output value is one CTA's fixed-order sum:
    two launches on the same operands agree bit for bit (every form the
    plan picks at these shapes)."""
    a, w, b, norm = _product_operands(cuda, rows, k, n, 7)
    first = fl.fused_linear(a, w, b, norm, gelu=True)
    assert torch.equal(first, fl.fused_linear(a, w, b, norm, gelu=True))


@pytest.mark.cuda
def test_shared_product_raises_outside_its_shapes(cuda):
    """On the card the product launches or raises: N a multiple of 8, K /
    segs of 32, weights in the activations' dtype."""
    a, w, b, _ = _product_operands(cuda, 64, 96, 24, 3)
    before = fl.launches
    with pytest.raises(ValueError):
        fl.fused_linear(a, w[:, :20].contiguous(), b[:20])
    with pytest.raises(ValueError):
        fl.fused_linear(a[:, :80].contiguous(), w[:80].contiguous(), b)
    with pytest.raises(ValueError):
        fl.fused_linear(a, w.float(), b)
    assert fl.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, label", [
    ("swin_mlp_bwd", "b4 stage0 x(256, 144, 192) bfloat16"),
    ("swin_mlp_bwd", "stage1 x(32, 144, 384) bfloat16"),
    ("swin_mlp_bwd", "stage2 x(8, 144, 768) float32"),
    ("swin_attn_bwd", "b4 stage0 x(256, 144, 192) mask bfloat16"),
    ("swin_attn_bwd", "stage1 x(32, 144, 384) nomask bfloat16"),
    ("swin_attn_bwd", "stage2 x(8, 144, 768) mask float32"),
])
def test_training_backwards_repeat_bit_for_bit(cuda, kernel, label):
    """B9c and B9b sum every gradient over the rows and windows in a fixed
    order (chunks of the launch plan, then the chunks in order; no floating-
    point atomics): two launches on the same inputs give the same bits in
    every output, the weight, bias, LayerNorm and dbias gradients included."""
    case = next(c for c in _cases.CASES[kernel](cuda) if c.label == label)
    first = [t.clone() for t in case.run_kernel()]
    again = case.run_kernel()
    torch.cuda.synchronize()
    assert len(first) == len(again)
    for i, (f, g) in enumerate(zip(first, again)):
        assert torch.equal(f, g), f"output {i} differs between two launches"


@pytest.mark.cuda
@pytest.mark.parametrize("layout, m, n, k", [
    ("xw", 36864, 768, 192), ("dywt", 36864, 192, 768), ("atb", 192, 768, 36864),
    ("atb", 768, 192, 36864), ("xw", 577, 200, 72), ("dywt", 1153, 104, 584),
    ("atb", 200, 584, 1160), ("atb", 8, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_product_in_each_layout(cuda, layout, m, n, k, dtype):
    """The training backwards' product alone (`grad_product`) against fp32
    products of the same stored values, at the XE step's stage-0 shapes and
    at ragged ones (partial tiles and chunks): fp32 sums in another order
    only, held to 1e-5 of the result's largest magnitude."""
    g = torch.Generator().manual_seed(m + n + k)
    shapes = {"xw": ((m, k), (k, n)), "dywt": ((m, k), (n, k)), "atb": ((k, m), (k, n))}[layout]
    a, b = (torch.randn(s, generator=g).to(cuda, dtype) for s in shapes)
    before = fl.grad_launches
    got = fl.grad_product(a, b, layout)
    want = fl.grad_product_reference(a, b, layout)
    assert fl.grad_launches == before + 1
    abs_err, rel_err, ok = _cases.compare(got, want, (1e-5 * float(want.abs().max()), 0.0))
    assert ok, f"max_abs {abs_err:.3e} max_rel {rel_err:.3e}"
    assert torch.equal(got, fl.grad_product(a, b, layout))
    if layout != "atb" and dtype == torch.bfloat16:  # rounded to bf16, as dao's
        got = fl.grad_product(a, b, layout, rounded=True)
        want = fl.grad_product_reference(a, b, layout, rounded=True)
        assert got.dtype == dtype
        abs_err, rel_err, ok = _cases.compare(got, want, _cases.TOL[dtype])
        assert ok, f"rounded: max_abs {abs_err:.3e} max_rel {rel_err:.3e}"


def _embed_operands(cuda, shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    rn = lambda s, scale=1.0: (torch.randn(s, generator=g) * scale).to(cuda)  # noqa: E731
    x = rn(shape).to(dtype)
    proj = (rn((48, 192), 48 ** -0.5).to(dtype), rn((192,), 0.2))
    return x, proj, (rn((192,), 0.2) + 1.0, rn((192,), 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 12, 12, 48), (3, 24, 24, 48), (2, 96, 96, 48),
                                   (8, 96, 96, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_embed_every_grid_and_partial_tiles(cuda, shape, dtype):
    """B7 against its plain version where the last row tile is partial (144
    and 1728 rows) and at the main path's batches; bf16 also on grids other
    than the plan's (one CTA, a few, one a tile); every launch bit for bit
    the same as the first."""
    x, proj, norm = _embed_operands(cuda, shape, dtype, sum(shape))
    want = sb.patch_embed_reference(x, proj, norm, 12, 1e-5)
    first = sb.patch_embed_fused(x, proj, norm, 12, 1e-5)
    plans = [None]
    if dtype == torch.bfloat16:
        rows = shape[0] * shape[1] * shape[2]
        tiles = -(-rows // sb.EMBED_ROWS)
        plans += [sb.EmbedPlan(rows, tiles, c) for c in {1, 3, tiles}]
    for plan in plans:
        got = sb.patch_embed_launch(x, proj, norm, 12, 1e-5, plan)
        abs_err, rel_err, ok = _cases.compare(got, want, _cases.TOL[dtype])
        assert ok, f"{plan}: max_abs {abs_err:.3e} max_rel {rel_err:.3e}"
        assert torch.equal(got, first), f"{plan} differs from the plan's launch"


@pytest.mark.cuda
@pytest.mark.parametrize("b, stage", [(2, 0), (2, 1), (2, 2)] + _cases.MAIN_PATH_MERGES)
def test_downsample_every_plan_bit_for_bit(cuda, b, stage):
    """B8 in bf16 in every tile form and K split `merge_plan` takes (the
    plan's among them), and in fp32 on the CUDA cores, against the plain
    version; two launches of one plan agree bit for bit (no atomics: a
    split's partial tiles are summed in rank order). b1 stage 2's 144 rows
    leave the last row tile partial."""
    from on_device_image_captioning_torch.ops import linear_plan as lp

    c, _, res = _cases.STAGES[stage]
    g = torch.Generator().manual_seed(970 + 10 * b + stage)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((b * (res // 12) ** 2, 144, c), generator=g)).to(cuda, dtype)
        norm = ((torch.randn(4 * c, generator=g) * 0.2 + 1.0).to(cuda),
                (torch.randn(4 * c, generator=g) * 0.2).to(cuda))
        w = (torch.randn((4 * c, 2 * c), generator=g) * (4 * c) ** -0.5).to(cuda, dtype)
        a = (x, norm, w, res // 12, 12, 1e-5)
        want = sb.downsample_reference(*a)
        plans = [sb.downsample_plan(x)]
        if dtype == torch.bfloat16:
            for form in range(len(lp.FORMS)):
                for splits in lp.MERGE_SPLITS:
                    try:
                        plans.append(sb.downsample_plan(x, form, splits))
                    except ValueError:
                        pass
        for plan in plans:
            got = sb.downsample_launch(*a, plan=plan)
            abs_err, rel_err, ok = _cases.compare(got, want, _cases.TOL[dtype])
            assert ok, f"{dtype} {plan}: max_abs {abs_err:.3e} max_rel {rel_err:.3e}"
            assert torch.equal(got, sb.downsample_launch(*a, plan=plan)), f"{plan} repeats"


@pytest.mark.cuda
@pytest.mark.parametrize("b, stage", [(8, 0), (1, 1)])
def test_downsample_product_alone_repeats_the_whole_call(cuda, b, stage):
    """B8's second launch alone (prologue_ready), on what the first left in
    scratch, writes what the whole call writes, on either route: the
    scratch route at b8 stage 0, the split at b1 stage 1."""
    c, _, res = _cases.STAGES[stage]
    g = torch.Generator().manual_seed(990 + 10 * b + stage)
    x = torch.randn((b * (res // 12) ** 2, 144, c), generator=g).to(cuda, torch.bfloat16)
    norm = ((torch.randn(4 * c, generator=g) * 0.2 + 1.0).to(cuda),
            (torch.randn(4 * c, generator=g) * 0.2).to(cuda))
    w = (torch.randn((4 * c, 2 * c), generator=g) * (4 * c) ** -0.5).to(cuda, torch.bfloat16)
    a = (x, norm, w, res // 12, 12, 1e-5)
    plan = sb.downsample_plan(x)
    assert plan.ring == (stage == 1)
    scratch = sb.downsample_scratch(x, plan)
    whole = sb.downsample_launch(*a, scratch=scratch)
    assert torch.equal(sb.downsample_launch(*a, scratch=scratch, prologue_ready=True), whole)


@pytest.mark.cuda
def test_stage_boundaries_raise_outside_their_shapes(cuda):
    """B8 takes the plan of its own shapes and dtype, and its product alone
    only on scratch of its route's shape already there; B7's grid must be its route's; neither
    launches on what it refuses."""
    x = torch.randn((32, 144, 384), device=cuda, dtype=torch.bfloat16)
    norm = (torch.ones(1536, device=cuda), torch.zeros(1536, device=cuda))
    w = torch.randn((1536, 768), device=cuda, dtype=torch.bfloat16)
    a = (x, norm, w, 4, 12, 1e-5)
    other = sb.downsample_plan(torch.randn((8, 144, 768), device=cuda, dtype=torch.bfloat16))
    e, proj, enorm = _embed_operands(cuda, (1, 12, 12, 48), torch.bfloat16, 1)
    before = (sb.downsample_launches, sb.patch_embed_launches)
    with pytest.raises(ValueError, match="other shapes"):
        sb.downsample_launch(*a, plan=other)
    with pytest.raises(ValueError, match="other shapes"):
        sb.downsample_launch(x.float(), norm, w.float(), 4, 12, 1e-5, plan=sb.downsample_plan(x))
    with pytest.raises(ValueError, match="prologue_ready"):
        sb.downsample_launch(*a, prologue_ready=True)
    with pytest.raises(ValueError, match="scratch must be"):
        sb.downsample_launch(*a, scratch=torch.empty((288, 2), device=cuda))
    with pytest.raises(ValueError):
        sb.downsample_plan(x, splits=9)
    with pytest.raises(ValueError, match="other rows"):
        sb.patch_embed_launch(e, proj, enorm, 12, 1e-5, sb.EmbedPlan(288, 5, 5))
    with pytest.raises(ValueError, match="another route"):
        sb.patch_embed_launch(e.float(), (proj[0].float(), proj[1]), enorm, 12, 1e-5,
                              sb.EmbedPlan(144, 3, 3))
    assert before == (sb.downsample_launches, sb.patch_embed_launches)
