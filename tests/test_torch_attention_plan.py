"""The launch plan of the window-attention core (`ops/window_attention.py::
attention_plan`, which K1, B3, B4 and B10a hand to `csrc/window_attention.cuh`)
on the CPU: a pure function of the shapes and the card's SM count, held to the
constants of its C source. At every shape a kernel case or the main path
gives the core, and at 132 SMs (the H100 SXM) and 114 (the H100 PCIe): the
choice pinned, every (window, head) taken once by a CTA that reads one mask
row and whole heads, and the CTA within the card's shared memory and
registers."""
import pathlib
import re

import pytest
import torch

from on_device_image_captioning_torch.ops import _cases
from on_device_image_captioning_torch.ops import window_attention as k1

SOURCE = (pathlib.Path(k1.__file__).resolve().parents[1] / "csrc" /
          "window_attention.cuh").read_text()
SMS = [132, 114]
F32, BF16 = torch.float32, torch.bfloat16


def _windows(stage: int) -> int:
    return (_cases.STAGES[stage][2] // _cases.WINDOW) ** 2


def _shapes():
    """(bw, nW, heads, masked, dtype, n) of every call of the core a kernel
    case makes (ops/_cases.py: K1 and B3 at B = 2 and their main-path
    shapes; B4 and B10a at B = 2 and B4's main-path shapes), of the XE step's
    b4, and windows of other sizes on the CUDA cores."""
    out = set()
    for stage, (_, heads, _) in enumerate(_cases.STAGES):
        nw = _windows(stage)
        for dt in (F32, BF16):
            for m in (True, False):
                out.add((2 * nw, nw, heads, m, dt, 144))
                if stage < 3:
                    out.add((4 * nw, nw, heads, m, dt, 144))
    for b, stage, n_model in _cases.MAIN_PATH_TP:
        for dt in (F32, BF16):
            out.add((b * _windows(stage), _windows(stage), _cases.STAGES[stage][1] // n_model,
                     True, dt, 144))
    for b, stage, m in _cases.MAIN_PATH_ATTN:
        out.add((b * _windows(stage), _windows(stage), _cases.STAGES[stage][1], m, BF16, 144))
    for b, stage in _cases.MAIN_PATH_HALVES:
        out.add((b * _windows(stage), _windows(stage), _cases.STAGES[stage][1], True, BF16, 144))
    for n, bw, nw, heads in [(16, 8, 4, 2), (49, 12, 4, 3), (64, 32, 16, 6), (100, 6, 3, 4),
                             (192, 4, 2, 6), (7, 3, 1, 1)]:
        for dt in (F32, BF16):
            for m in (True, False):
                out.add((bw, nw, heads, m, dt, n))
    return sorted(out, key=lambda s: (s[5], s[0], s[1], s[2], s[3], str(s[4])))


SHAPES = _shapes()
IDS = [f"n{n}-bw{bw}-nw{nw}-h{h}-{'mask' if m else 'nomask'}-{str(dt)[6:]}"
       for bw, nw, h, m, dt, n in SHAPES]


def _constant(name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1).split("//")[0].strip()


def test_plan_constants_match_the_source():
    assert int(_constant("kHeadDim")) == k1.HEAD_DIM
    assert int(_constant("kWindowTokens")) == k1.MMA_TOKENS
    assert _constant("kMmaThreads") == "32 * (kWindowTokens / 16)"
    assert k1.MMA_THREADS == 32 * (k1.MMA_TOKENS // 16)
    assert int(_constant("kCoreMaxTokens")) == k1.CORE_MAX_TOKENS
    assert _constant("kCoreLd") == "kHeadDim + 4" and k1.CORE_LD == k1.HEAD_DIM + 4
    assert _constant("kMaskLd") == "kWindowTokens + 8"
    assert "n + ((18 - n % 16) % 16)" in SOURCE  # core_bm_ld, mirrored by _core_bm_ld
    assert "((4 * ((n + 1) / 2)) + 31) / 32 * 32" in SOURCE  # core_threads
    # the CTA order units_of mirrors: group fastest, then the run of heads, then the share
    assert "r.p = cta % a.groups;" in SOURCE
    assert "const int run = rest % runs, share = rest / runs;" in SOURCE


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("bw, nw, heads, masked, dtype, n", SHAPES, ids=IDS)
def test_plan_covers_every_unit_once(bw, nw, heads, masked, dtype, n, sms):
    """Every (window, head) once; each CTA has work, one mask row (the
    windows of a masked CTA agree on w % nW) and a run of heads that divides
    the heads; the CTAs as many as the grid the kernel launches."""
    plan = k1.attention_plan(bw, nw, heads, masked, dtype, sms, n)
    assert plan.groups == (nw if masked else 1)
    assert heads % plan.heads_per_cta == 0
    assert 1 <= plan.splits <= bw // plan.groups
    assert plan.ctas == plan.groups * (heads // plan.heads_per_cta) * plan.splits
    seen = []
    for cta in range(plan.ctas):
        units = plan.units_of(cta, bw, heads)
        assert units, f"CTA {cta} has no unit"
        assert len({w % plan.groups for w, _ in units}) == 1
        assert len({h for _, h in units}) <= plan.heads_per_cta
        seen += units
    assert sorted(seen) == [(w, h) for w in range(bw) for h in range(heads)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("bw, nw, heads, masked, dtype, n", SHAPES, ids=IDS)
def test_plan_fits_the_card(bw, nw, heads, masked, dtype, n, sms):
    """The route is the tensor cores exactly for bf16 windows of 144 tokens;
    a CTA's shared memory and its threads' registers fit one SM of the H100
    (one CTA an SM), in whole warps. The registers are ptxas's figures
    (k1.REGISTERS), held to the loaded kernels on the card by
    tests/test_torch_kernels.py::test_attention_core_resources_match_ptxas."""
    plan = k1.attention_plan(bw, nw, heads, masked, dtype, sms, n)
    assert plan.route == ("mma" if dtype == BF16 and n == 144 else "cores")
    assert plan.smem_bytes <= k1.SMEM_LIMIT
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads * plan.registers <= k1.SM_REGISTERS
    if plan.route == "mma":
        assert plan.threads == k1.MMA_THREADS
        assert plan.smem_bytes == 2 * 3 * 144 * 64 + 128 + (1 + masked) * 144 * 152 * 4
    else:
        assert plan.threads >= 4 * ((n + 1) // 2)  # a quad of lanes every two rows
        assert plan.smem_bytes == (2 * n * k1.CORE_LD + n * k1._core_bm_ld(n)) * 4
        assert k1._core_bm_ld(n) % 16 == 2 and k1._core_bm_ld(n) >= n


# (bw, nW, heads, masked, dtype, n, sms) -> (heads a CTA, splits): the plan's
# choice at every shape above
PINNED = {
    (3, 1, 1, False, 'bfloat16', 7, 132): (1, 3),
    (3, 1, 1, False, 'float32', 7, 132): (1, 3),
    (3, 1, 1, True, 'bfloat16', 7, 132): (1, 3),
    (3, 1, 1, True, 'float32', 7, 132): (1, 3),
    (8, 4, 2, False, 'bfloat16', 16, 132): (1, 8),
    (8, 4, 2, False, 'float32', 16, 132): (1, 8),
    (8, 4, 2, True, 'bfloat16', 16, 132): (1, 2),
    (8, 4, 2, True, 'float32', 16, 132): (1, 2),
    (12, 4, 3, False, 'bfloat16', 49, 132): (1, 12),
    (12, 4, 3, False, 'float32', 49, 132): (1, 12),
    (12, 4, 3, True, 'bfloat16', 49, 132): (1, 3),
    (12, 4, 3, True, 'float32', 49, 132): (1, 3),
    (32, 16, 6, False, 'bfloat16', 64, 132): (1, 16),
    (32, 16, 6, False, 'float32', 64, 132): (1, 16),
    (32, 16, 6, True, 'bfloat16', 64, 132): (1, 1),
    (32, 16, 6, True, 'float32', 64, 132): (1, 1),
    (6, 3, 4, False, 'bfloat16', 100, 132): (1, 6),
    (6, 3, 4, False, 'float32', 100, 132): (1, 6),
    (6, 3, 4, True, 'bfloat16', 100, 132): (1, 2),
    (6, 3, 4, True, 'float32', 100, 132): (1, 2),
    (1, 1, 48, False, 'bfloat16', 144, 132): (1, 1),
    (2, 1, 48, False, 'bfloat16', 144, 132): (1, 2),
    (2, 1, 48, False, 'float32', 144, 132): (1, 2),
    (2, 1, 48, True, 'bfloat16', 144, 132): (1, 2),
    (2, 1, 48, True, 'float32', 144, 132): (1, 2),
    (4, 4, 24, False, 'bfloat16', 144, 132): (1, 4),
    (4, 4, 24, True, 'bfloat16', 144, 132): (1, 1),
    (8, 1, 48, False, 'bfloat16', 144, 132): (3, 8),
    (8, 4, 24, False, 'bfloat16', 144, 132): (1, 4),
    (8, 4, 24, False, 'float32', 144, 132): (1, 4),
    (8, 4, 24, True, 'bfloat16', 144, 132): (1, 1),
    (8, 4, 24, True, 'float32', 144, 132): (1, 1),
    (16, 4, 24, False, 'bfloat16', 144, 132): (3, 16),
    (16, 4, 24, False, 'float32', 144, 132): (3, 16),
    (16, 4, 24, True, 'bfloat16', 144, 132): (3, 4),
    (16, 4, 24, True, 'float32', 144, 132): (3, 4),
    (16, 16, 12, False, 'bfloat16', 144, 132): (1, 8),
    (16, 16, 12, True, 'bfloat16', 144, 132): (2, 1),
    (32, 4, 24, False, 'bfloat16', 144, 132): (2, 11),
    (32, 4, 24, True, 'bfloat16', 144, 132): (3, 4),
    (32, 16, 12, False, 'bfloat16', 144, 132): (1, 11),
    (32, 16, 12, False, 'float32', 144, 132): (1, 11),
    (32, 16, 12, True, 'bfloat16', 144, 132): (3, 2),
    (32, 16, 12, True, 'float32', 144, 132): (3, 2),
    (64, 16, 12, False, 'bfloat16', 144, 132): (1, 11),
    (64, 16, 12, False, 'float32', 144, 132): (1, 11),
    (64, 16, 12, True, 'bfloat16', 144, 132): (3, 2),
    (64, 16, 12, True, 'float32', 144, 132): (3, 2),
    (64, 64, 6, False, 'bfloat16', 144, 132): (1, 22),
    (64, 64, 6, True, 'bfloat16', 144, 132): (3, 1),
    (128, 16, 12, False, 'bfloat16', 144, 132): (1, 11),
    (128, 16, 12, True, 'bfloat16', 144, 132): (3, 2),
    (128, 64, 6, False, 'bfloat16', 144, 132): (1, 22),
    (128, 64, 6, False, 'float32', 144, 132): (1, 22),
    (128, 64, 6, True, 'bfloat16', 144, 132): (3, 1),
    (128, 64, 6, True, 'float32', 144, 132): (3, 1),
    (256, 64, 6, False, 'bfloat16', 144, 132): (1, 22),
    (256, 64, 6, False, 'float32', 144, 132): (1, 22),
    (256, 64, 6, True, 'bfloat16', 144, 132): (3, 1),
    (256, 64, 6, True, 'float32', 144, 132): (3, 1),
    (512, 64, 3, True, 'bfloat16', 144, 132): (3, 2),
    (512, 64, 3, True, 'float32', 144, 132): (3, 2),
    (512, 64, 6, False, 'bfloat16', 144, 132): (1, 22),
    (512, 64, 6, True, 'bfloat16', 144, 132): (3, 1),
    (4, 2, 6, False, 'bfloat16', 192, 132): (1, 4),
    (4, 2, 6, False, 'float32', 192, 132): (1, 4),
    (4, 2, 6, True, 'bfloat16', 192, 132): (1, 2),
    (4, 2, 6, True, 'float32', 192, 132): (1, 2),
    (3, 1, 1, False, 'bfloat16', 7, 114): (1, 3),
    (3, 1, 1, False, 'float32', 7, 114): (1, 3),
    (3, 1, 1, True, 'bfloat16', 7, 114): (1, 3),
    (3, 1, 1, True, 'float32', 7, 114): (1, 3),
    (8, 4, 2, False, 'bfloat16', 16, 114): (1, 8),
    (8, 4, 2, False, 'float32', 16, 114): (1, 8),
    (8, 4, 2, True, 'bfloat16', 16, 114): (1, 2),
    (8, 4, 2, True, 'float32', 16, 114): (1, 2),
    (12, 4, 3, False, 'bfloat16', 49, 114): (1, 12),
    (12, 4, 3, False, 'float32', 49, 114): (1, 12),
    (12, 4, 3, True, 'bfloat16', 49, 114): (1, 3),
    (12, 4, 3, True, 'float32', 49, 114): (1, 3),
    (32, 16, 6, False, 'bfloat16', 64, 114): (1, 16),
    (32, 16, 6, False, 'float32', 64, 114): (1, 16),
    (32, 16, 6, True, 'bfloat16', 64, 114): (1, 1),
    (32, 16, 6, True, 'float32', 64, 114): (1, 1),
    (6, 3, 4, False, 'bfloat16', 100, 114): (1, 6),
    (6, 3, 4, False, 'float32', 100, 114): (1, 6),
    (6, 3, 4, True, 'bfloat16', 100, 114): (1, 2),
    (6, 3, 4, True, 'float32', 100, 114): (1, 2),
    (1, 1, 48, False, 'bfloat16', 144, 114): (1, 1),
    (2, 1, 48, False, 'bfloat16', 144, 114): (1, 2),
    (2, 1, 48, False, 'float32', 144, 114): (1, 2),
    (2, 1, 48, True, 'bfloat16', 144, 114): (1, 2),
    (2, 1, 48, True, 'float32', 144, 114): (1, 2),
    (4, 4, 24, False, 'bfloat16', 144, 114): (1, 4),
    (4, 4, 24, True, 'bfloat16', 144, 114): (1, 1),
    (8, 1, 48, False, 'bfloat16', 144, 114): (1, 2),
    (8, 4, 24, False, 'bfloat16', 144, 114): (1, 4),
    (8, 4, 24, False, 'float32', 144, 114): (1, 4),
    (8, 4, 24, True, 'bfloat16', 144, 114): (1, 1),
    (8, 4, 24, True, 'float32', 144, 114): (1, 1),
    (16, 4, 24, False, 'bfloat16', 144, 114): (1, 4),
    (16, 4, 24, False, 'float32', 144, 114): (1, 4),
    (16, 4, 24, True, 'bfloat16', 144, 114): (1, 1),
    (16, 4, 24, True, 'float32', 144, 114): (1, 1),
    (16, 16, 12, False, 'bfloat16', 144, 114): (1, 8),
    (16, 16, 12, True, 'bfloat16', 144, 114): (2, 1),
    (32, 4, 24, False, 'bfloat16', 144, 114): (1, 4),
    (32, 4, 24, True, 'bfloat16', 144, 114): (1, 1),
    (32, 16, 12, False, 'bfloat16', 144, 114): (1, 8),
    (32, 16, 12, False, 'float32', 144, 114): (1, 8),
    (32, 16, 12, True, 'bfloat16', 144, 114): (2, 1),
    (32, 16, 12, True, 'float32', 144, 114): (2, 1),
    (64, 16, 12, False, 'bfloat16', 144, 114): (1, 8),
    (64, 16, 12, False, 'float32', 144, 114): (1, 8),
    (64, 16, 12, True, 'bfloat16', 144, 114): (2, 1),
    (64, 16, 12, True, 'float32', 144, 114): (2, 1),
    (64, 64, 6, False, 'bfloat16', 144, 114): (1, 16),
    (64, 64, 6, True, 'bfloat16', 144, 114): (2, 1),
    (128, 16, 12, False, 'bfloat16', 144, 114): (2, 19),
    (128, 16, 12, True, 'bfloat16', 144, 114): (2, 1),
    (128, 64, 6, False, 'bfloat16', 144, 114): (1, 19),
    (128, 64, 6, False, 'float32', 144, 114): (1, 19),
    (128, 64, 6, True, 'bfloat16', 144, 114): (2, 1),
    (128, 64, 6, True, 'float32', 144, 114): (1, 2),
    (256, 64, 6, False, 'bfloat16', 144, 114): (1, 19),
    (256, 64, 6, False, 'float32', 144, 114): (1, 19),
    (256, 64, 6, True, 'bfloat16', 144, 114): (2, 1),
    (256, 64, 6, True, 'float32', 144, 114): (1, 2),
    (512, 64, 3, True, 'bfloat16', 144, 114): (1, 1),
    (512, 64, 3, True, 'float32', 144, 114): (1, 4),
    (512, 64, 6, False, 'bfloat16', 144, 114): (1, 19),
    (512, 64, 6, True, 'bfloat16', 144, 114): (1, 2),
    (4, 2, 6, False, 'bfloat16', 192, 114): (1, 4),
    (4, 2, 6, False, 'float32', 192, 114): (1, 4),
    (4, 2, 6, True, 'bfloat16', 192, 114): (1, 2),
    (4, 2, 6, True, 'float32', 192, 114): (1, 2),
}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("bw, nw, heads, masked, dtype, n", SHAPES, ids=IDS)
def test_plan_choice_is_pinned(bw, nw, heads, masked, dtype, n, sms):
    plan = k1.attention_plan(bw, nw, heads, masked, dtype, sms, n)
    key = (bw, nw, heads, masked, str(dtype)[6:], n, sms)
    assert (plan.heads_per_cta, plan.splits) == PINNED[key]


@pytest.mark.parametrize("args, match", [
    ((8, 4, 2, True, torch.float16, 132, 144), "dtype"),
    ((8, 4, 2, True, F32, 132, 193), "tokens"),
    ((8, 4, 2, True, F32, 132, 0), "tokens"),
    ((9, 4, 2, True, BF16, 132, 144), "no launch"),
    ((0, 4, 2, False, BF16, 132, 144), "no launch"),
    ((8, 4, 0, False, BF16, 132, 144), "no launch"),
    ((8, 4, 2, False, BF16, 0, 144), "no launch"),
])
def test_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        k1.attention_plan(*args)


def test_plan_main_path_splits():
    """At the H100's 132 SMs: stage 0 masked at B = 2 and b8 takes three
    heads a CTA over its mask row's images (128 CTAs, one wave), so the mask
    is read once for six units (B = 2) or 24 (b8); B3's two windows of 48
    heads are a CTA each (window, head); an unmasked stage spreads the
    windows of one head over the card."""
    assert (lambda p: (p.heads_per_cta, p.splits, p.ctas))(
        k1.attention_plan(128, 64, 6, True, BF16, 132)) == (3, 1, 128)
    assert (lambda p: (p.heads_per_cta, p.splits, p.ctas))(
        k1.attention_plan(512, 64, 6, True, BF16, 132)) == (3, 1, 128)
    assert (lambda p: (p.heads_per_cta, p.splits, p.ctas))(
        k1.attention_plan(2, 1, 48, False, BF16, 132)) == (1, 2, 96)
    p = k1.attention_plan(512, 64, 6, False, BF16, 132)
    assert p.heads_per_cta == 1 and p.ctas <= 132 and p.groups == 1


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors K1 is its plain version, whatever the plan would say."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn((8, 16, 3 * 64), generator=g)
    bias = torch.randn((2, 16, 16), generator=g)
    mask = torch.where(torch.rand((4, 16, 16), generator=g) > 0.7, -100.0, 0.0)
    before = k1.launches
    got = k1.window_attention(qkv, bias, mask, 2, 0.25)
    assert torch.equal(got, k1.window_attention_reference(qkv, bias, mask, 2, 0.25))
    assert k1.launches == before


def test_resource_instances_match_the_source():
    """`kernel_resources` names the instances in the order of the C source's
    `attention_attributes`; the register figures cover every route and the
    local-memory figures every instance at both roundings, none on the
    tensor-core route (the card test holds the figures to the loaded
    kernels)."""
    body = SOURCE[SOURCE.index("static int attention_attributes"):]
    body = body[:body.index("};")]
    found = re.findall(r"window_attention_(mma|core)_kernel<([^>]*)>", body)
    want = []
    for route, dtype in k1.INSTANCES:
        if route == "mma":
            want.append(("mma", "FUSED"))
        else:
            t = "float" if dtype == F32 else "__nv_bfloat16"
            n = "kWindowTokens / 4" if route == "cores" else "kCoreMaxTokens / 4"
            want.append(("core", f"{t}, FUSED, {n}"))
    assert found == want
    assert set(k1.REGISTERS) == {r for r, _ in k1.INSTANCES}
    assert {f: len(v) for f, v in k1.LOCAL_BYTES.items()} == {False: 5, True: 5}
    assert k1.LOCAL_BYTES[False][0] == k1.LOCAL_BYTES[True][0] == 0  # the tensor cores
