"""The window-attention core, checkout against checkout, in turns; and this
checkout's core in every split its plan weighs.

    python -m on_device_image_captioning_torch.cli.attention_turns \
        --trees PARENT . . PARENT [--out FILE]
    python -m on_device_image_captioning_torch.cli.attention_turns --splits [--out FILE]

--trees: each tree (the root of a checkout holding
`on_device_image_captioning_torch/`) is measured in a process of its own, in
the order given, so that two versions compare on one card in one call
(parent, change, change, parent). In each: K1 (`ops/window_attention.py::
window_attention`) at the B = 2 shapes of every stage, masked and not, bf16
and fp32, at the model-axis shard shape (b8 stage 0, 3 of 6 heads), and at
the `"pallas"` encode's own calls (b8 and b1, stages 0-3, bf16, masked where
the encode masks), beside `scaled_dot_product_attention` on the same tensors
(a yardstick the port never calls); and B4 (`ops/swin_block_fused.py::
swin_attn_half`, whose core is the same kernel) at its main-path shapes.
Device ms a call: 20 calls captured in a CUDA graph, replayed three times
between CUDA events (`cli/product_forms.py::graph_ms`). Only what every tree
has is called, on seeded inputs made the same way in every tree.

--splits: this tree's K1 at the encode's shapes in every split (heads a CTA,
shares of the images) of up to three waves of CTAs, device ms beside the
plan's cost of each, the plan's own marked.

The last line is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

from .breakdown import card_name

# (label, batch, stage, heads or 0 for the stage's, masked, dtype) of K1, and
# (label, batch, stage) of B4 (bf16, the mask, the transition 0 -> 6)
K1_SHAPES = (
    [(f"stage{s} {'mask' if m else 'nomask'} {dt}", 2, s, 0, m, dt)
     for dt in ("bfloat16", "float32") for s in range(4) for m in (True, False)]
    + [(f"b8 stage0 tp2 mask {dt}", 8, 0, 3, True, dt) for dt in ("bfloat16", "float32")]
    + [(f"b{b} stage{s} {'mask' if m else 'nomask'} bfloat16", b, s, 0, m, "bfloat16")
       for b in (8, 1) for s in range(4) for m in ((True, False) if s < 3 else (False,))])
B4_SHAPES = [(f"b{b} stage{s}", b, s) for b, s in
             ((2, 2), (8, 2), (1, 2), (8, 0), (8, 1), (1, 0), (1, 1))]

# run in each tree's root, on that tree's package
_HELPERS = r'''
import json, sys
import torch
sys.path.insert(0, ".")
from on_device_image_captioning_torch.cli.product_forms import graph_ms
from on_device_image_captioning_torch.models.swin import shift_attn_mask
from on_device_image_captioning_torch.ops import swin_block_fused as sbf
from on_device_image_captioning_torch.ops import window_attention as k1

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
F = torch.nn.functional
STAGES = [(192, 6, 96), (384, 12, 48), (768, 24, 24), (1536, 48, 12)]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def k1_args(b, stage, heads, masked, dtype):
    c, stage_heads, res = STAGES[stage]
    heads = heads or stage_heads
    nw = (res // 12) ** 2
    g = torch.Generator().manual_seed(700 + 10 * b + stage)
    qkv = torch.randn((b * nw, 144, 3 * heads * 32), generator=g).to("cuda", DTYPES[dtype])
    bias = (torch.randn((heads, 144, 144), generator=g) * 0.5).cuda()
    mask = None
    if masked and nw > 1:
        mask = torch.from_numpy(shift_attn_mask(res, 12, 6)).cuda()
    elif masked:
        mask = torch.where(torch.rand((1, 144, 144), generator=g) > 0.7, -100.0, 0.0).cuda()
    return qkv, bias, mask, heads, 32 ** -0.5


def sdpa(qkv, bias, mask, heads, scale):
    bw, n, c3 = qkv.shape
    q, k, v = qkv.reshape(bw, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    add = bias[None]
    if mask is not None:
        nw = mask.shape[0]
        add = (bias[None, None] + mask[None, :, None]).expand(
            bw // nw, nw, heads, n, n).reshape(bw, heads, n, n)
    add = add.to(qkv.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=scale)


def b4_args(b, stage):
    c, heads, res = STAGES[stage]
    g = torch.Generator().manual_seed(760 + 10 * b + stage)
    dt = torch.bfloat16
    x = torch.randn((b * (res // 12) ** 2, 144, c), generator=g).to("cuda", dt)
    norm = (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))
    lin = lambda k, n: ((torch.randn((k, n), generator=g) * k ** -0.5).to("cuda", dt),  # noqa: E731
                        (torch.randn((n,), generator=g) * 0.1).cuda())
    bias = (torch.randn((heads, 144, 144), generator=g) * 0.5).cuda()
    mask = torch.from_numpy(shift_attn_mask(res, 12, 6)).cuda()
    return (x, norm, lin(c, 3 * c), lin(c, c), bias, mask, heads, 32 ** -0.5, 1e-5, (res, 0, 6))
'''

_MEASURE = _HELPERS + r'''
k1_shapes, b4_shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {"k1": {}, "sdpa": {}, "b4": {}}
for label, b, stage, heads, masked, dtype in k1_shapes:
    a = k1_args(b, stage, heads, masked, dtype)
    out["k1"][label] = graph_ms(lambda: k1.window_attention(*a))
    out["sdpa"][label] = graph_ms(sdpa(*a))
for label, b, stage in b4_shapes:
    a = b4_args(b, stage)
    out["b4"][label] = graph_ms(lambda: sbf.swin_attn_half(*a))
print(json.dumps(out))
'''

_SPLITS = _HELPERS + r'''
from on_device_image_captioning_torch.ops.linear_plan import sm_count

k1_shapes = json.loads(sys.argv[1])
sms = sm_count(torch.device("cuda"))
out = {}
for label, b, stage, heads, masked, dtype in k1_shapes:
    qkv, bias, mask, heads, scale = k1_args(b, stage, heads, masked, dtype)
    nw = 1 if mask is None else mask.shape[0]
    plan = k1.attention_plan(qkv.shape[0], nw, heads, masked, qkv.dtype, sms)
    images = qkv.shape[0] // plan.groups
    rows = []
    for run in (g for g in range(1, heads + 1) if heads % g == 0):
        per_split = plan.groups * (heads // run)
        wanted = {1, 2, 3, 4, 6, 8} | {max(1, w * sms // per_split) for w in (1, 2, 3)}
        for splits in sorted(s for s in wanted if s <= images and per_split * s <= 3 * sms):
            ctas = per_split * splits
            cost = -(-ctas // sms) * (k1.MASK_COST[plan.route] * masked + run * (
                k1.HEAD_COST[plan.route] + k1.UNIT_COST * -(-images // splits)))
            ms = graph_ms(lambda: k1._window_attention_cuda(qkv, bias, mask, heads, scale,
                                                            split=(run, splits)))
            rows.append({"heads_per_cta": run, "splits": splits, "ctas": ctas, "ms": ms,
                         "cost": cost, "planned": (run, splits) == (plan.heads_per_cta,
                                                                      plan.splits)})
    out[label] = rows
print(json.dumps(out))
'''


def run(script: str, tree: str, *args: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=tree, capture_output=True,
                          text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"attention_turns: {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def turns(trees, card):
    shapes = json.dumps(K1_SHAPES), json.dumps(B4_SHAPES)
    runs = []
    for i, tree in enumerate(trees):
        got = run(_MEASURE, tree, *shapes)
        runs.append({"tree": tree, **got})
        for label, ms in got["k1"].items():
            print(f"turn {i} {tree}: K1 {label}: device {ms:.4f} ms, sdpa "
                  f"{got['sdpa'][label]:.4f} ms | {card}", flush=True)
        for label, ms in got["b4"].items():
            print(f"turn {i} {tree}: B4 {label}: device {ms:.4f} ms | {card}", flush=True)
    means = {}
    for tree in dict.fromkeys(trees):
        rs = [r for r in runs if r["tree"] == tree]
        means[tree] = {part: {label: statistics.mean(r[part][label] for r in rs)
                              for label in rs[0][part]} for part in ("k1", "sdpa", "b4")}
    if len(means) == 2:
        base, cand = means.values()
        for part in ("k1", "b4"):
            for label in base[part]:
                ratio = cand[part][label] / base[part][label]
                print(f"{part} {label}: {list(means)[1]} {cand[part][label]:.4f} against "
                      f"{list(means)[0]} {base[part][label]:.4f} ms, ratio {ratio:.3f}; sdpa "
                      f"{cand['sdpa'].get(label, float('nan')):.4f} | {card}", flush=True)
    return {"card": card, "runs": runs, "means": means}


def splits(card):
    got = run(_SPLITS, ".", json.dumps([s for s in K1_SHAPES if s[0].startswith("b")]))
    for label, rows in got.items():
        for r in rows:
            print(f"K1 {label}: {r['heads_per_cta']} heads a CTA, {r['splits']} shares, "
                  f"{r['ctas']} CTAs: device {r['ms']:.4f} ms, cost {r['cost']}"
                  f"{' (the plan)' if r['planned'] else ''} | {card}", flush=True)
    return {"card": card, "splits": got}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--trees", nargs="+")
    mode.add_argument("--splits", action="store_true")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    card = card_name()
    print(card, flush=True)
    result = turns(args.trees, card) if args.trees else splits(card)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
