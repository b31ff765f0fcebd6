"""The whole-block kernel B6 in every cluster layout its plan can build, on one card.

    python -m on_device_image_captioning_torch.cli.block_forms [--out FILE]

At B6's cases of the main path's shapes and the kernel table's shape (bf16,
mask and transition 0 -> 6; `ops/_cases.py`): B6 launched in every layout
`ops/block_plan.py` can build (CTAs a window), the one the plan picks marked,
each held to its plain version; beside it the two halves it replaces (B4 +
B5, their cases at the same shapes). Device ms by CUDA-graph replay. Then:

- the clusters the card runs at once, by size (`cudaOccupancyMaxActiveClusters`:
  what `block_plan.CLUSTER_SLOTS` records);
- the plan's fixed cost of a CTA (`block_plan.CTA_OVERHEAD`), fitted to the
  table shape's times at 3 and 6 CTAs a window: a wave of clusters takes
  W * (the busiest rank's share of a window) + O;
- how often x1 (the block's mid residual) of B6 (through B9a with unit
  scales) and of B4 differs from the plain version's, at b8 stage 1 for a few
  seeds: both round where the plain version rounds, and a rounding boundary
  crossed upstream shows as one bf16 ulp of x1.

The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import json

import torch

from ..models.swin import shift_attn_mask
from ..ops import _cases
from ..ops import block_plan as bp
from ..ops import swin_block_fused as sbf
from .breakdown import card_name
from .product_forms import graph_ms

TABLE = "stage0 x(128, 144, 192) mask trans0to6 bfloat16"
FLIP_SEEDS = (1221, 1321, 1421)


@contextlib.contextmanager
def forced_plan(plan: bp.BlockPlan):
    """B6 / B9a launched in `plan`'s layout instead of the plan's pick."""
    saved = sbf.plan_for
    sbf.plan_for = lambda x, heads, hidden: plan
    try:
        yield
    finally:
        sbf.plan_for = saved


def _halves_ms(prefix: str, dev) -> dict:
    out = {}
    for name, cases in (("B4", _cases.swin_attn_half_cases), ("B5", _cases.swin_mlp_half_cases)):
        case = next((c for c in cases(dev) if c.label.startswith(prefix)), None)
        if case is not None:
            out[name] = graph_ms(case.run_kernel)
    return out


def _layouts(dev, sms: int) -> list:
    rows = []
    for case in _cases.swin_block_cases(dev):
        if not (case.label == TABLE or case.label[:1] == "b"):
            continue
        x = case.args[0]
        bw, c = x.shape[0], x.shape[2]
        pick = bp.block_plan(bw, c, c // 32, 4 * c, 2, sms).cluster
        ms, errs = {}, {}
        for cs in range(1, bp.MAX_CLUSTER + 1):
            plan = bp._columns_plan(bw, c, c // 32, 4 * c, cs)
            if plan is None:
                continue
            with forced_plan(plan):
                (part, got, want, tol), = case.check()
                abs_err, _, ok = _cases.compare(got, want, tol)
                ms[cs] = graph_ms(case.run_kernel)
            errs[cs] = (abs_err, ok)
        halves = _halves_ms(case.label.split(" x(")[0] + " ", dev) if case.label[:1] == "b" else {}
        print(f"B6 {case.label}: " + ", ".join(
            f"{cs}{'*' if cs == pick else ''} CTAs {t:.4f} ms ({'ok' if errs[cs][1] else 'FAIL'})"
            for cs, t in ms.items())
            + (f"; B4 + B5 {halves['B4']:.4f} + {halves['B5']:.4f}" if len(halves) == 2 else "")
            + f" | {card_name()}", flush=True)
        rows.append({"case": case.label, "windows": bw, "c": c, "plan": pick, "ms": ms,
                     "ok": {cs: e[1] for cs, e in errs.items()}, "halves_ms": halves})
    return rows


def _fit_overhead(rows: list, sms: int):
    row = next((r for r in rows if r["case"] == TABLE), None)
    if row is None or not {3, 6} <= set(row["ms"]):
        return None
    per_wave, share = {}, {}
    for cs in (3, 6):
        plan = bp._columns_plan(row["windows"], row["c"], row["c"] // 32, 4 * row["c"], cs)
        per_wave[cs] = row["ms"][cs] / -(-row["windows"] // bp.cluster_slots(cs, sms))
        share[cs] = bp.busiest_share(plan)
    work = (per_wave[3] - per_wave[6]) / (share[3] - share[6])
    fixed = per_wave[3] - work * share[3]
    return {"window_ms": work, "cta_fixed_ms": fixed, "overhead": fixed / work}


def _x1_agreement(dev) -> list:
    c, heads, res = _cases.STAGES[1]
    out = []
    for seed in FLIP_SEEDS:
        g = torch.Generator().manual_seed(seed)
        bw, dt = 8 * (res // _cases.WINDOW) ** 2, torch.bfloat16
        x = _cases._randn((bw, _cases.N_TOKENS, c), g, dev, dtype=dt)
        norm1, qkv, proj = (_cases._norm(c, g, dev), _cases._linear(c, 3 * c, g, dev, dt),
                            _cases._linear(c, c, g, dev, dt))
        norm2, fc1, fc2 = (_cases._norm(c, g, dev), _cases._linear(c, 4 * c, g, dev, dt),
                           _cases._linear(4 * c, c, g, dev, dt))
        bias = _cases._randn((heads, _cases.N_TOKENS, _cases.N_TOKENS), g, dev, scale=0.5)
        mask = torch.from_numpy(shift_attn_mask(res, _cases.WINDOW, _cases.SHIFT)).to(dev)
        trans, scale = (res, 0, _cases.SHIFT), 32 ** -0.5
        attn = (x, norm1, qkv, proj, bias, mask, heads, scale, 1e-5, trans)
        x1 = sbf.swin_attn_half_reference(*attn)
        x1_b4 = sbf.swin_attn_half(*attn)
        xt = sbf.window_transition_reference(x, res, _cases.WINDOW, 0, _cases.SHIFT)
        ones = torch.ones(8, device=dev)
        _, x1_b6 = sbf.swin_block_train_forward(xt, norm1, qkv, proj, norm2, fc1, fc2, bias, mask,
                                                ones, ones, heads, scale, 1e-5)
        a = (x, norm1, qkv, proj, norm2, fc1, fc2, bias, mask, heads, scale, 1e-5, trans)
        got, want = sbf.swin_block(*a), sbf.swin_block_reference(*a)
        over = int(((got.float() - want.float()).abs() > 2e-2 + 2e-2 * want.float().abs()).sum())
        n = x1.numel()
        row = {"seed": seed, "b6_x1_differs": int((x1_b6 != x1).sum()) / n,
               "b4_x1_differs": int((x1_b4 != x1).sum()) / n, "b6_out_over_bound": over,
               "outputs": got.numel()}
        print(f"x1 at b8 stage 1, seed {seed}: differs from the plain version in "
              f"{row['b6_x1_differs']:.4%} (B6) / {row['b4_x1_differs']:.4%} (B4) of elements; "
              f"B6 outputs over the cases' bound {over} of {got.numel()} | {card_name()}", flush=True)
        out.append(row)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("block_forms: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = _layouts(dev, sms)
    slots = {c: {k: bp.card_cluster_slots(c, k, 200000) for k in range(1, bp.MAX_CLUSTER + 1)}
             for c in bp.WIDTHS}
    print(f"clusters the card runs at once, by CTAs a cluster (200000 bytes a CTA): {slots[384]}"
          f" | {card_name()}", flush=True)
    fit = _fit_overhead(rows, sms)
    if fit is not None:
        print(f"fitted at the table's shape: a window's work {fit['window_ms']:.4f} ms a wave, a "
              f"CTA's fixed cost {fit['cta_fixed_ms']:.4f} ms: CTA_OVERHEAD {fit['overhead']:.3f}",
              flush=True)
    result = {"card": card_name(), "layouts": rows, "cluster_slots": slots, "overhead_fit": fit,
              "x1_agreement": _x1_agreement(dev)}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
