"""The stage-boundary kernels B7 and B8, checkout against checkout, in turns.

    python -m on_device_image_captioning_torch.cli.boundary_turns \
        --trees PARENT . . PARENT [--out FILE]

Each tree (the root of a checkout holding `on_device_image_captioning_torch/`)
is measured in a process of its own, in the order given, so that two versions
compare on one card in one call (parent, change, change, parent). In each,
after building every kernel source of the tree at once, through the tree's
own wrappers on the same seeded bf16 inputs:

- B7 (`ops/stage_boundary.py::patch_embed_fused`) at B = 2, 8 and 1
  ((B, 96, 96, 48) -> C = 192) and B8 (`downsample_fused`) after stages 0, 1
  and 2 at B = 2, 8 and 1: device ms (20 calls captured in a CUDA graph,
  replayed three times between CUDA events) and back-to-back ms (20 calls
  between CUDA events: the host's wrapper and launch included);
- the kernels this change must leave as they were: the phase-6 headline
  cases of B4, B5, B6 and K1 (the tree's own `ops/_cases.py`, found by
  label), device ms.

The last line is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

from .encode_turns import card_name

# run in each tree's root, on that tree's package: only what every tree has
_MEASURE = r'''
import json, sys
import torch
sys.path.insert(0, ".")
from on_device_image_captioning_torch.ops import _build, _cases
from on_device_image_captioning_torch.ops import stage_boundary as sb

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.compile_all()
dev, bf = torch.device("cuda"), torch.bfloat16
HEADLINES = {
    "swin_attn_half": "stage2 x(8, 144, 768) mask trans0to6 bfloat16",
    "swin_mlp_half": "stage2 x(8, 144, 768) bfloat16",
    "swin_block": "stage0 x(128, 144, 192) mask trans0to6 bfloat16",
    "window_attention": "stage0 qkv(128, 144, 576) H6 mask bfloat16",
}


def graph_ms(fn, iters=20):
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


def b2b_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rn(g, shape, scale=1.0, dt=torch.float32):
    return (torch.randn(shape, generator=g) * scale).to(dev, dt)


out = {}
for b in (2, 8, 1):
    g = torch.Generator().manual_seed(1300 + b)
    x = rn(g, (b, 96, 96, 48), dt=bf)
    proj = (rn(g, (48, 192), 48 ** -0.5, bf), rn(g, (192,), 0.2))
    norm = (rn(g, (192,), 0.2) + 1.0, rn(g, (192,), 0.2))
    fn = lambda: sb.patch_embed_fused(x, proj, norm, 12, 1e-5)
    out[f"patch_embed b{b}"] = {"device_ms": graph_ms(fn), "b2b_ms": b2b_ms(fn)}
for b in (2, 8, 1):
    for stage, (c, res) in enumerate(((192, 96), (384, 48), (768, 24))):
        g = torch.Generator().manual_seed(1310 + 10 * b + stage)
        x = rn(g, (b * (res // 12) ** 2, 144, c), dt=bf)
        norm = (rn(g, (4 * c,), 0.2) + 1.0, rn(g, (4 * c,), 0.2))
        w = rn(g, (4 * c, 2 * c), (4 * c) ** -0.5, bf)
        fn = lambda: sb.downsample_fused(x, norm, w, res // 12, 12, 1e-5)
        out[f"downsample b{b} stage{stage}"] = {"device_ms": graph_ms(fn), "b2b_ms": b2b_ms(fn)}
for name, label in HEADLINES.items():
    case = next(c for c in _cases.CASES[name](dev) if c.label == label)
    out[f"{name} {label}"] = {"device_ms": graph_ms(case.run_kernel)}
print(json.dumps(out))
'''


def measure(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _MEASURE], cwd=tree, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"boundary_turns: {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", required=True)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    card = card_name()
    print(card, flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        got = measure(tree)
        runs.append({"tree": tree, "times": got})
        for key, r in got.items():
            b2b = f", b2b {r['b2b_ms']:.4f} ms" if "b2b_ms" in r else ""
            print(f"turn {i} {tree}: {key}: device {r['device_ms']:.4f} ms{b2b} | {card}",
                  flush=True)
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).append(r["times"])
    summary = {tree: {key: statistics.mean(t[key]["device_ms"] for t in ts) for key in ts[0]}
               for tree, ts in by_tree.items()}
    trees = list(summary)
    for key in summary[trees[0]]:
        print(f"{key}: mean device ms " + ", ".join(
            f"{tree} {summary[tree][key]:.4f}" for tree in trees)
            + (f" (ratio {summary[trees[1]][key] / summary[trees[0]][key]:.3f})"
               if len(trees) > 1 else "") + f" | {card}", flush=True)
    line = json.dumps({"card": card, "runs": runs, "mean_device_ms": summary})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
