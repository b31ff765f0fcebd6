"""Every inference kernel of the port is a `torch.library` op of the namespace
`odic`: its CPU kernel is the plain version, its CUDA kernel the launch, and
it has a fake implementation for tracing.

On the CPU, at small shapes built as `ops/_cases.py` builds its cases: each
wrapper reaches exactly its op (recorded by a dispatch mode), the op's result
is bit-equal to the plain version called directly, and
`torch.library.opcheck` passes (schema, fake tensors, autograd registration,
AOT dispatch). The list of ops is pinned to the wrappers, and every function
of `ops/` that launches a kernel (it checks the launch's status) is an op's
CUDA kernel or one of the training launches, which stay behind their
autograd functions.
"""
import ast
import pathlib

import pytest
import torch

from on_device_image_captioning_torch.deploy import aot
from on_device_image_captioning_torch.models.swin import shift_attn_mask
from on_device_image_captioning_torch.ops import _build, _cases
from on_device_image_captioning_torch.ops import dyn_exp_step as k2
from on_device_image_captioning_torch.ops import fused_linear as fl
from on_device_image_captioning_torch.ops import layernorm as k4
from on_device_image_captioning_torch.ops import quant_matmul as qm
from on_device_image_captioning_torch.ops import stage_boundary as sb
from on_device_image_captioning_torch.ops import swin_block_fused as sbf
from on_device_image_captioning_torch.ops import topk as k3
from on_device_image_captioning_torch.ops import window_attention as k1

OPS_DIR = pathlib.Path(k4.__file__).resolve().parent

# op -> the wrapper (module.function) whose body calls it
WRAPPERS = {
    "window_attention": "window_attention.window_attention",
    "swin_block": "swin_block_fused.swin_block",
    "swin_attn_half": "swin_block_fused.swin_attn_half",
    "swin_mlp_half": "swin_block_fused.swin_mlp_half",
    "swin_mlp_half_a8": "swin_block_fused.swin_mlp_half_a8",
    "mlp_a8_product": "swin_block_fused.mlp_a8_product",
    "window_transition": "swin_block_fused.window_transition",
    "patch_embed": "stage_boundary.patch_embed_launch",
    "downsample": "stage_boundary.downsample_launch",
    "quantize_activation": "quant_matmul.quantize_activation",
    "int8_product": "quant_matmul.int8_product",
    "fused_linear": "fused_linear.fused_linear",
    "layernorm": "layernorm.layernorm",
    "topk": "topk.topk",
    "dyn_exp_step": "dyn_exp_step.dyn_exp_step",
    "dyn_exp_cross_step": "dyn_exp_step.dyn_exp_cross_step",
}
# the training kernels' launches: behind their autograd functions, not ops yet
TRAINING_LAUNCHES = {
    "swin_block_train_forward", "swin_attn_half_train_forward", "swin_mlp_half_train_forward",
    "swin_mlp_bwd", "swin_attn_bwd", "grad_product",
}


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _randn(shape, g, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _norm(c, g):
    return _randn((c,), g, 0.2) + 1.0, _randn((c,), g, 0.2)


def _linear(k, n, g, dtype=torch.float32, bias=True):
    return _randn((k, n), g, k ** -0.5, dtype), (_randn((n,), g, 0.2) if bias else None)


def _int8(n, k, g):
    return (torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8),
            (torch.rand((n,), generator=g) + 0.5) * (k ** -0.5 / 73.0))


# small windows: 4 x 4 tokens (N = 16), a grid of 8 x 8 (4 windows an
# image), 2 images, C = 64 in 2 heads, shift 2
N, RES, WIN, SHIFT, C, HEADS, BW = 16, 8, 4, 2, 64, 2, 8


def _block_args(dtype, g, masked=True, transition=None):
    x = _randn((BW, N, C), g, dtype=dtype)
    mask = torch.from_numpy(shift_attn_mask(RES, WIN, SHIFT)) if masked else None
    return (x, _norm(C, g), _linear(C, 3 * C, g, dtype), _linear(C, C, g, dtype), _norm(C, g),
            _linear(C, 4 * C, g, dtype), _linear(4 * C, C, g, dtype),
            _randn((HEADS, N, N), g, 0.5), mask, HEADS, (C // HEADS) ** -0.5, 1e-5, transition)


def _step_args(fused, g):
    b, bs, L, E, d, s, group = 4, 2, 5, 4, 16, 6, 2
    src = [_randn((bs, L, d), g) for _ in range(4)] + [_randn((bs, L, E, d), g) for _ in range(2)]
    dst = [torch.empty((b, L, d)) for _ in range(4)] + [torch.empty((b, L, E, d))
                                                         for _ in range(2)]
    ops = (2, torch.tensor([0, 0, 1, 1], dtype=torch.int32), _randn((b, E, d), g),
           _randn((b, E, d), g), _randn((b, d), g), _randn((b, d), g), _randn((b, d), g),
           _randn((b, d), g), torch.sigmoid(_randn((b, d), g)), _randn((E, d), g))
    if not fused:
        return ops + (src, dst)
    enc_mask = torch.ones((b // group, s))
    enc_mask[1, -2:] = 0.0
    tail = (_randn((b, d), g), _norm(d, g), *_linear(d, d, g), *_linear(d, d, g),
            _randn((b // group, s, d), g), _randn((b // group, s, d), g), enc_mask)
    return ops + tail + (src, dst)


def _calls():
    """(label, wrapper call, plain call) at small shapes for every op, its
    options included."""
    g = _g(0)
    for dt in (torch.float32, torch.bfloat16):
        qkv = _randn((BW, N, 3 * C), g, dtype=dt)
        bias = _randn((HEADS, N, N), g, 0.5)
        mask = torch.from_numpy(shift_attn_mask(RES, WIN, SHIFT))
        for m in (mask, None):
            a = (qkv, bias, m, HEADS, 0.25)
            yield "window_attention", a, k1.window_attention, k1.window_attention_reference
        a = _block_args(dt, g, transition=(RES, 0, SHIFT))
        yield "swin_block", a, sbf.swin_block, sbf.swin_block_reference
        yield "swin_attn_half", a[:4] + a[7:], sbf.swin_attn_half, sbf.swin_attn_half_reference
        a = _block_args(dt, g, masked=False)
        yield "swin_block", a, sbf.swin_block, sbf.swin_block_reference
        yield ("swin_mlp_half", (a[0], a[4], a[5], a[6], 1e-5), sbf.swin_mlp_half,
               sbf.swin_mlp_half_reference)
        x = _randn((BW, N, C), g, dtype=dt)
        a = (x, _norm(C, g), (*_int8(4 * C, C, g), _randn((4 * C,), g)),
             (*_int8(C, 4 * C, g), _randn((C,), g)), 1e-5)
        yield "swin_mlp_half_a8", a, sbf.swin_mlp_half_a8, sbf.swin_mlp_half_a8_reference
        yield ("swin_mlp_half_a8", a + (True,), sbf.swin_mlp_half_a8,
               sbf.swin_mlp_half_a8_reference)
        yield ("window_transition", (x, RES, WIN, SHIFT, 0), sbf.window_transition,
               sbf.window_transition_reference)
        x_s2d = _randn((2, RES, RES, 48), g, dtype=dt)
        a = (x_s2d, _linear(48, C, g, dt), _norm(C, g), WIN, 1e-5)
        yield "patch_embed", a, sb.patch_embed_fused, sb.patch_embed_reference
        yield "patch_embed", a, sb.patch_embed_launch, sb.patch_embed_reference
        xw = _randn((BW, N, 32), g, dtype=dt)
        a = (xw, _norm(128, g), _linear(128, 64, g, dt, bias=False)[0], 2, WIN, 1e-5)
        yield "downsample", a, sb.downsample_fused, sb.downsample_reference
        yield "downsample", a, sb.downsample_launch, sb.downsample_reference
        x = _randn((6, 32), g, dtype=dt)
        for x_scale in (None, torch.tensor([0.02])):
            w_q, w_scale = _int8(16, 32, g)
            a = (x, w_q, w_scale, _randn((16,), g), x_scale)
            yield "quantized_matmul", a, qm.quantized_matmul, qm.quantized_matmul_reference
        a = (_randn((12, 64), g, dtype=dt), *_linear(64, 32, g, dt))
        yield "fused_linear", a, fl.fused_linear, fl.fused_linear_reference
        ln = _norm(64, g)
        yield ("fused_linear", a + (ln,), lambda *a: fl.fused_linear(*a, gelu=True),
               lambda *a: fl.fused_linear_reference(*a, gelu=True))
        rows = _randn((2 * RES * RES, 64), g, dtype=dt)
        w, b = _linear(64, 64, g, dt)
        gather = ("transition", RES, WIN, SHIFT)
        kw = dict(gather=gather, resid=rows, resid_gather=gather, row_scale=torch.tensor([1., 2.]))
        yield ("fused_linear", (rows, w, b, ln), lambda *a, kw=kw: fl.fused_linear(*a, **kw),
               lambda *a, kw=kw: fl.fused_linear_reference(*a, **kw))
        merge = ("merge", RES, WIN, 0)
        w4, b4 = _linear(256, 64, g, dt)
        kw4 = dict(m=2 * RES * RES // 4, gather=merge)
        yield ("fused_linear", (rows, w4, b4, _norm(256, g)),
               lambda *a, kw=kw4: fl.fused_linear(*a, **kw),
               lambda *a, kw=kw4: fl.fused_linear_reference(*a, **kw))
        yield "layernorm", (_randn((5, 3, C), g, dtype=dt), *_norm(C, g)), k4.layernorm, \
            k4.layernorm_reference
        x = _randn((4, 40), g, dtype=dt)
        yield "topk", (x, 3), k3.topk, k3.topk_reference
        x = x.clone()
        x[1, 7] = float("nan")
        yield "topk NaN", (x, 3), k3.topk, k3.topk_reference
    g = _g(1)
    for fused in (False, True):
        a = _step_args(fused, g)
        if fused:
            kw = dict(heads=2, ln_eps=1e-5, attn_fill=-1e4, group=2)
            yield ("dyn_exp_cross_step", (a, kw),
                   lambda a, kw: k2.dyn_exp_cross_step(*a, **kw),
                   lambda a, kw: k2.dyn_exp_cross_step_reference(*a[:-1], **kw))
        else:
            yield ("dyn_exp_step", (a,), lambda a: k2.dyn_exp_step(*a),
                   lambda a: k2.dyn_exp_step_reference(*a[:-1]))
    a_q = torch.randint(-127, 128, (12, 64), generator=g, dtype=torch.int8)
    fc1 = (*_int8(96, 64, g), _randn((96,), g))
    fc2 = (*_int8(64, 96, g), None)
    h_q = torch.randint(-127, 128, (12, 96), generator=g, dtype=torch.int8)
    a_scale = torch.rand((12,), generator=g) + 0.5
    yield "mlp_a8_product", (a_q, a_scale, fc1), sbf.mlp_a8_product, sbf.mlp_a8_product_reference
    for resid in (_randn((12, 64), g), _randn((12, 64), g, dtype=torch.bfloat16)):
        yield ("mlp_a8_product", (h_q, a_scale * 127, fc2, resid), sbf.mlp_a8_product,
               sbf.mlp_a8_product_reference)


CALLS = list(_calls())
IDS = [f"{i}-{name}" for i, (name, *_) in enumerate(CALLS)]
# opcheck compares outputs with NaN as unequal: its calls hold no NaN
OPCHECK = [i for i, (name, *_) in enumerate(CALLS) if not name.endswith("NaN")]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("i", range(len(CALLS)), ids=IDS)
def test_op_cpu_kernel_is_the_plain_version(i):
    """The wrapper reaches its op(s), launches nothing, and its result is
    bit-equal to the plain version called directly on the same inputs (for
    the decode steps: the output and the written caches)."""
    name, args, wrapper, plain = CALLS[i]
    name = name.split()[0]
    counters = _cases_launch_counters()
    calls = _cases.op_calls(lambda: wrapper(*args))
    got = wrapper(*args)
    want = plain(*args)
    if name.startswith("dyn_exp"):
        dst = args[0][-1]
        got, want = [got, *dst], [want[0], *want[1]]
    want_ops = {"quantized_matmul": ["quantize_activation", "int8_product"]}.get(name, [name])
    assert [op.__name__.split(".")[0] for op, *_ in calls] == want_ops
    for g_, w_ in zip(_flat(got), _flat(want)):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        assert torch.equal(g_, w_) or torch.equal(torch.isnan(g_), torch.isnan(w_)) and (
            torch.equal(g_.nan_to_num(), w_.nan_to_num()))
    assert _cases_launch_counters() == counters


@pytest.mark.parametrize("i", OPCHECK, ids=[IDS[i] for i in OPCHECK])
def test_opcheck_on_cpu(i):
    """`torch.library.opcheck` of every op call the wrapper makes."""
    _, args, wrapper, _ = CALLS[i]
    for op, op_args, op_kwargs in _cases.op_calls(lambda: wrapper(*args)):
        results = torch.library.opcheck(op, op_args, op_kwargs)
        assert set(results.values()) == {"SUCCESS"}, results


def _cases_launch_counters():
    return (k1.launches, k2.launches, k2.cross_launches, k3.launches, k4.launches,
            qm.launches, qm.quantize_launches, fl.launches, sb.patch_embed_launches,
            sb.downsample_launches, sbf.block_launches, sbf.attn_half_launches,
            sbf.mlp_half_launches, sbf.mlp_half_a8_launches, sbf.mlp_a8_product_launches,
            sbf.transition_launches)


def test_every_op_is_registered_and_called_by_its_wrapper():
    """The `odic` namespace holds exactly the inference ops, each defined by
    `define_op` in its kernel's module and called by its wrapper; the calls
    above reach every one of them."""
    aot.register_ops()
    registered = {n.split("::")[1].split(".")[0] for n in torch._C._dispatch_get_all_op_names()
                  if n.startswith("odic::")}
    assert registered == set(WRAPPERS) == set(_build.OPS)
    reached = {op.__name__.split(".")[0] for _, args, wrapper, _ in CALLS
               for op, *_ in _cases.op_calls(lambda: wrapper(*args))}
    assert reached == set(WRAPPERS)
    for op, where in WRAPPERS.items():
        module, fn = where.split(".")
        tree = ast.parse((OPS_DIR / f"{module}.py").read_text())
        body = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn)
        src = ast.unparse(body)
        assert "_op(" in src, (op, where)


def test_every_launch_is_an_op_or_a_training_kernel():
    """A function of `ops/` that launches a kernel (it checks the launch's
    status) is the CUDA kernel of an `odic` op, a helper only such a kernel
    calls (B13's launch, which the card tests also call for its scales), or
    a training launch: no wrapper keeps a direct path beside its op."""
    aot.register_ops()
    cuda_kernels = {cuda.__name__ for _, cuda in _build.OPS.values()}
    launching = set()
    for path in sorted(OPS_DIR.glob("*.py")):
        if path.name == "_build.py":  # defines check_status
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and "check_status(" in ast.unparse(node):
                launching.add(node.name)
    # `card_cluster_slots` queries the card's occupancy: it launches nothing
    want = cuda_kernels - {"_swin_mlp_half_a8_cuda"} | {"_launch_mlp_half_a8"}
    assert launching - {"card_cluster_slots"} == want | TRAINING_LAUNCHES
    src = (OPS_DIR / "swin_block_fused.py").read_text()
    assert src.count("_launch_mlp_half_a8(") == 2  # its definition and B13's CUDA kernel


def test_meta_tensors_get_the_fake_shapes():
    """The fake implementations give what the plain versions give, in shape
    and dtype, without computing (on meta tensors)."""
    for name, args, wrapper, plain in CALLS:
        if name.startswith("dyn_exp"):
            continue
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else
                tuple(t.to("meta") if isinstance(t, torch.Tensor) else t for t in a)
                if isinstance(a, tuple) else a for a in args]
        got, want = _flat(wrapper(*meta)), _flat(plain(*args))
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want], name
        assert all(t.is_meta for t in got)


def test_registration_builds_nothing():
    """Registering the ops compiles and loads no kernel library."""
    aot.register_ops()
    assert _build.load_cuda_library.cache_info().currsize == 0
