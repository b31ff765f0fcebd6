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
int8 MLP half by int8 steps and rows (see `swin_mlp_half_a8_cases`).
"""
import pytest
import torch

from on_device_image_captioning_torch.ops import _cases
from on_device_image_captioning_torch.ops import dyn_exp_step as k2
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


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [3, 12])
def test_window_attention_raises_on_other_head_widths(cuda, heads):
    """K1 is built for dk = 32 only (c = 192: 3 heads is dk 64, 12 is dk 16)."""
    qkv = torch.randn((4, 144, 576), device=cuda)
    bias = torch.zeros((heads, 144, 144), device=cuda)
    with pytest.raises(ValueError):
        k1.window_attention(qkv, bias, None, heads, 0.125)


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
    assert before == (qm.launches, sbf.mlp_half_a8_launches)
    out = qm.quantized_matmul(x[:, :32].contiguous(), w_q[:, :32].contiguous(), scale)
    assert out.dtype == torch.float32 and out.shape == (24, 64) and qm.launches == before[0] + 1
