"""Card-only checks: each hand-written kernel against its plain PyTorch version
on CUDA tensors, at main-path shapes (Swin-L/384 windows on both backbone
paths, the d512 decoder, V = 10000), and the wrappers' refusal of CUDA shapes
their kernel does not take. Marked `cuda`; without a card they skip (decided inside the fixture).
This file imports no JAX, so it runs on a card machine with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The cases and their tolerances live in `ops/_cases.py`, which `chip_smoke.py`
checks too: fp32 2e-5 abs + 1e-4 rel (summation order only); bf16 2e-2 abs +
2e-2 rel (one bf16 ulp is 2^-8 relative); top-k values and indices exactly.
"""
import pytest
import torch

from on_device_image_captioning_torch.ops import _cases
from on_device_image_captioning_torch.ops import dyn_exp_step as k2
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
