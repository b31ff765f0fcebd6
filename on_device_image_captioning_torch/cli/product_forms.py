"""The backbone's shared bf16 product alone in every tile form, on one card.

    python -m on_device_image_captioning_torch.cli.product_forms \
        [--backward | --int8 | --merge] [--out FILE]

At the main path's products (qkv, proj, fc1, fc2 of stage 2 at b8 and b1 and
of stage 0 at b8, each with its own epilogue: the LayerNorm prologue on qkv
and fc1, GELU on fc1, the residual on proj and fc2), the product
(`ops/fused_linear.py`) in each form of `ops/linear_plan.py::FORMS`, the form
the plan picks, and `F.linear` on the same tensors as a yardstick: device ms
by CUDA-graph replay (20 calls, replayed three times). These are the readings
the plan's model is held to. The last line is one JSON object.

With --backward the same for the training backwards' product
(`ops/fused_linear.py::grad_product`) at the XE step's b4 shapes of stages
0-2: B9c's dxn2, dW1, dW2 and B9b's dao, dxn1, dWproj, dWqkv, each in every
form of `ops/linear_plan.py::GRAD_FORMS` its layout takes (each with its own
split), the form the plan picks, and `torch.matmul` on the same operands.

With --int8 the same for the w8a8 MLP half B13 (`ops/swin_block_fused.py`)
at its main-path shapes (ops/_cases.py MAIN_PATH_A8, bf16): its two int8
products alone (`mlp_a8_product`: fc1 with its fp32 GELU epilogue, fc2 with
the residual) in every form of `ops/linear_plan.py::INT8_FORMS`, the form the
plan picks, and `torch._int_mm` on the same int8 operands; then the whole
call.

With --merge the same for the patch merging B8 (`ops/stage_boundary.py`,
bf16) at B = 2 and at its main-path shapes (ops/_cases.py MAIN_PATH_MERGES):
the whole call (both launches) in every tile form and K split
`ops/linear_plan.py::merge_plan` takes ("FxZ": form F, Z splits; Z = 1 is
the scratch route, Z > 1 the row-statistics pre-pass and the LayerNorm in the
ring), each first held to the plain version (ops/_cases.py's bf16
tolerance) and to a second launch (bit for bit); the plan's pick; `F.linear`
on the same normalized rows.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..ops import fused_linear as fl
from ..ops import linear_plan as lp
from .breakdown import card_name

# (label, rows, C): Swin-L/384 stage 2 at b8 and b1, stage 0 at b8
SHAPES = (("b8 stage2", 4608, 768), ("b1 stage2", 576, 768), ("b8 stage0", 73728, 192))


def graph_ms(fn, iters: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, default=None)
    kind = parser.add_mutually_exclusive_group()
    kind.add_argument("--backward", action="store_true",
                      help="the training backwards' product at the XE step's b4 shapes")
    kind.add_argument("--int8", action="store_true",
                      help="the w8a8 MLP half's products and hidden forms")
    kind.add_argument("--merge", action="store_true",
                      help="the patch merging's product in every tile form and K split")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("product_forms: needs a CUDA card")
    card, dev = card_name(), torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    rn = lambda shape, scale=1.0, dt=torch.float32: (  # noqa: E731
        torch.randn(shape, generator=g) * scale).to(dev, dt)
    if args.backward:
        return _write(backward_forms(card, dev, sms, rn), args.out)
    if args.int8:
        return _write(int8_forms(card, dev, sms, g), args.out)
    if args.merge:
        return _write(merge_forms(card, dev, sms), args.out)
    rows_out = []
    for label, m, c in SHAPES:
        x, h = rn((m, c), dt=torch.bfloat16), rn((m, 4 * c), dt=torch.bfloat16)
        for name, a, n, norm, gelu, resid in (("qkv", x, 3 * c, True, False, False),
                                              ("proj", x, c, False, False, True),
                                              ("fc1", x, 4 * c, True, True, False),
                                              ("fc2", h, c, False, False, True)):
            k = a.shape[1]
            w, b = rn((k, n), k ** -0.5, torch.bfloat16), rn((n,))
            ln = (rn((k,), 0.2) + 1.0, rn((k,), 0.2)) if norm else None
            r = x if resid else None
            ms = {f: graph_ms(lambda f=f: fl.fused_linear(a, w, b, ln, gelu=gelu, resid=r, form=f))
                  for f in range(len(lp.FORMS)) if k % lp.FORMS[f].bk == 0}
            w_t = w.t().contiguous()
            lib = graph_ms(lambda: F.linear(a, w_t))
            plan = lp.linear_plan(m, n, k, 1, 2, sms).form
            tf = 2 * m * n * k / 1e9
            print(f"{label} {name} ({m}, {k}) -> {n}: "
                  + ", ".join(f"form {f}{'*' if f == plan else ''} {t:.4f} ms "
                              f"({tf / t:.0f} TFLOP/s)" for f, t in ms.items())
                  + f"; F.linear {lib:.4f} ms ({tf / lib:.0f} TFLOP/s) | {card}", flush=True)
            rows_out.append({"shape": label, "product": name, "m": m, "n": n, "k": k,
                             "form_ms": ms, "plan": plan, "f_linear_ms": lib})
    return _write({"card": card, "forms": [list(map(int, (f.bm, f.bn, f.bk, f.stages, f.ctas)))
                                           for f in lp.FORMS], "products": rows_out}, args.out)


def _write(result: dict, out) -> dict:
    line = json.dumps(result)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


def backward_forms(card: str, dev, sms: int, rn) -> dict:
    """The backward product in every form at the XE step's b4 shapes."""
    rows_out = []
    for stage, (c, res) in enumerate(((192, 96), (384, 48), (768, 24))):
        r = 4 * res * res
        for name, m, n, k, layout in (("dxn2", r, c, 4 * c, "dywt"), ("dW1", c, 4 * c, r, "atb"),
                                      ("dW2", 4 * c, c, r, "atb"), ("dao", r, c, c, "dywt"),
                                      ("dxn1", r, c, 3 * c, "dywt"), ("dWproj", c, c, r, "atb"),
                                      ("dWqkv", c, 3 * c, r, "atb")):
            shapes = {"dywt": ((m, k), (n, k)), "atb": ((k, m), (k, n))}[layout]
            a, b = (rn(sh, dt=torch.bfloat16) for sh in shapes)
            ms = {}
            for f, form in enumerate(lp.GRAD_FORMS):
                if layout == "dywt" or form.bn % 64 == 0:  # an MN-major B in 64-column blocks
                    ms[f] = graph_ms(lambda f=f: fl.grad_product(a, b, layout, form=f))
            x = a.t() if layout == "atb" else a
            y = b.t() if layout == "dywt" else b
            lib = graph_ms(lambda: torch.matmul(x, y))
            plan = lp.grad_plan(m, n, k, layout, 2, sms).form
            tf = 2 * m * n * k / 1e9
            print(f"b4 stage{stage} {name} ({m} x {n}, K {k}, {layout}): "
                  + ", ".join(f"form {f}{'*' if f == plan else ''} {t:.4f} ms "
                              f"({tf / t:.0f} TFLOP/s)" for f, t in ms.items())
                  + f"; torch.matmul {lib:.4f} ms ({tf / lib:.0f} TFLOP/s) | {card}", flush=True)
            rows_out.append({"shape": f"b4 stage{stage}", "product": name, "m": m, "n": n,
                             "k": k, "layout": layout, "form_ms": ms, "plan": plan,
                             "matmul_ms": lib})
    return {"card": card, "forms": [list(map(int, (f.bm, f.bn, f.bk, f.stages, f.ctas)))
                                    for f in lp.GRAD_FORMS], "products": rows_out}


def int8_forms(card: str, dev, sms: int, g) -> dict:
    """B13's products in every int8 form and the whole call, at the main
    path's w8a8 shapes."""
    from ..ops import _cases
    from ..ops import swin_block_fused as sbf

    ri = lambda shape: torch.randint(  # noqa: E731
        -127, 128, shape, generator=g, dtype=torch.int8).to(dev)
    ru = lambda shape, lo, hi: (  # noqa: E731
        torch.rand(shape, generator=g) * (hi - lo) + lo).to(dev)
    rows_out, halves = [], []
    for b, stage in _cases.MAIN_PATH_A8:
        c, _, res = _cases.STAGES[stage]
        m, label = b * res * res, f"b{b} stage{stage}"
        for name, k, n, fc2 in (("fc1", c, 4 * c, False), ("fc2", 4 * c, c, True)):
            a_q, w_q = ri((m, k)), ri((n, k))
            lin = (w_q, ru((n,), 0.5, 1.5) * (k ** -0.5 / 73.0), ru((n,), -0.2, 0.2))
            if fc2:
                a_scale = ru((m,), 1.0, 2.0)
                resid = torch.randn((m, n), generator=g).to(dev, torch.bfloat16)
            else:
                a_scale, resid = ru((m,), 0.5, 1.5) / 127.0, None
            ms = {f: graph_ms(lambda f=f: sbf.mlp_a8_product(a_q, a_scale, lin, resid, form=f))
                  for f in range(len(lp.INT8_FORMS))}
            w_t = w_q.t()
            lib = graph_ms(lambda: torch._int_mm(a_q, w_t))
            plan = lp.int8_plan(m, n, k, sms).form
            tops = 2 * m * n * k / 1e9
            print(f"{label} {name} ({m}, {k}) -> {n}: "
                  + ", ".join(f"form {f}{'*' if f == plan else ''} {t:.4f} ms "
                              f"({tops / t:.0f} TOP/s)" for f, t in ms.items())
                  + f"; torch._int_mm {lib:.4f} ms ({tops / lib:.0f} TOP/s) | {card}", flush=True)
            rows_out.append({"shape": label, "product": name, "m": m, "n": n, "k": k,
                             "form_ms": ms, "plan": plan, "int_mm_ms": lib})
        case = next(x for x in _cases.swin_mlp_half_a8_cases(dev) if x.label.startswith(label))
        ms = graph_ms(case.time_kernel)
        print(f"{label} B13 {case.label}: {ms:.4f} ms | {card}", flush=True)
        halves.append({"shape": label, "ms": ms})
    return {"card": card, "forms": [list(map(int, (f.bm, f.bn, f.stages, f.ctas)))
                                    for f in lp.INT8_FORMS], "products": rows_out,
            "halves": halves}


def merge_forms(card: str, dev, sms: int) -> dict:
    """B8 in every tile form and K split at B = 2 and the main path's shapes."""
    from ..ops import _cases
    from ..ops import layernorm as k4
    from ..ops import stage_boundary as sb

    rows_out = []
    for case in _cases.downsample_cases(dev):
        if "bfloat16" not in case.label:
            continue
        xw, norm, w, w_in, window, eps = case.args
        m, n, k = xw.shape[0] * xw.shape[1] // 4, w.shape[1], w.shape[0]
        want = case.run_plain()
        pick = lp.merge_plan(m, n, k, 4, 2, sms)
        ms = {}
        for f in range(len(lp.FORMS)):
            for z in lp.MERGE_SPLITS:
                try:
                    plan = lp.merge_plan(m, n, k, 4, 2, sms, form=f, splits=z)
                except ValueError:
                    continue
                run = lambda plan=plan: sb.downsample_launch(*case.args, plan=plan)  # noqa: E731
                got = run()
                if not _cases.compare(got, want, _cases.TOL[torch.bfloat16])[2]:
                    raise AssertionError(f"merge_forms: {case.label} form {f} x {z} splits "
                                         f"disagrees with the plain version")
                if not torch.equal(got, run()):
                    raise AssertionError(f"merge_forms: {case.label} form {f} x {z} splits "
                                         f"differs between two launches")
                ms[f"{f}x{z}"] = graph_ms(run)
        rows = k4.layernorm_reference(sb._merged_rows(xw, w_in, window), *norm, eps)
        rows = rows.reshape(m, k)
        w_t = w.t().contiguous()
        lib = graph_ms(lambda: F.linear(rows, w_t))
        key = f"{pick.form}x{pick.splits}"
        print(f"downsample {case.label} ({m}, {k}) -> {n}: "
              + ", ".join(f"{fz}{'*' if fz == key else ''} {t:.4f}" for fz, t in ms.items())
              + f" ms (form x splits; x1 the scratch route); F.linear {lib:.4f} ms | {card}",
              flush=True)
        rows_out.append({"shape": case.label, "m": m, "n": n, "k": k, "ms": ms, "plan": key,
                         "f_linear_ms": lib})
    return {"card": card, "forms": [list(map(int, (f.bm, f.bn, f.bk, f.stages, f.ctas)))
                                    for f in lp.FORMS], "merges": rows_out}


if __name__ == "__main__":
    main()
