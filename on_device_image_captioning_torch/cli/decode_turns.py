"""K3 and K4, and the decodes that launch them, checkout against checkout, in turns.

    python -m on_device_image_captioning_torch.cli.decode_turns \
        --trees PARENT . . PARENT [--out FILE]

Each tree (the root of a checkout holding `on_device_image_captioning_torch/`)
is measured in a process of its own, in the order given, so that two versions
compare on one card in one call (parent, change, change, parent). In each,
after building every kernel source of the tree at once:

- K4 (`ops/layernorm.py::layernorm`) and K3 (`ops/topk.py::topk`) through
  the tree's own wrappers, at the main path's shapes (seeded inputs): device
  ms (20 calls captured in a CUDA graph, replayed three times between CUDA
  events) and back-to-back ms (20 calls between CUDA events: the host's
  wrapper and launch included);
- the decode (`Captioner.decode`) of Swin-L/384 + the d512 captioner, bf16,
  seeded random weights, of the serve cell (b8 / beam 3 / L20) and the
  latency cell (b1 / beam 5 / L74), with the step of form D (`"pallas_fused"`,
  B16) and of form H (`"pallas"`, K2): wall ms (the median of three after a
  warm-up) and device ms and launches (one `torch.profiler` pass), both by
  the tree's `cli/breakdown` helpers, and the device ms and calls of K3 and
  K4 in that pass (kernels named `topk_kernel...` and `layernorm_...`).

The decode does not depend on the backbone, so each cell encodes its seeded
uint8 images once on the `"fused"` backbone. The last line is one JSON
object with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

# run in each tree's root, on that tree's package: only what every tree has
_MEASURE = r'''
import dataclasses, json, statistics, sys
import numpy as np
import torch
sys.path.insert(0, ".")
from on_device_image_captioning_torch.api import Captioner
from on_device_image_captioning_torch.cli import breakdown
from on_device_image_captioning_torch.config import end_expansionnet_v2_coco
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2, init_weights
from on_device_image_captioning_torch.ops import _build, layernorm, topk

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
breakdown.TOP_KERNELS = 10 ** 6  # keep every kernel of the profiled pass
_build.compile_all()
dev = torch.device("cuda")


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


kernels = {}
g = torch.Generator().manual_seed(12)
for rows, c, dt in ((24, 512, torch.float32), (5, 512, torch.float32),
                    (18432, 192, torch.bfloat16), (73728, 192, torch.bfloat16),
                    (1152, 512, torch.bfloat16), (1152, 1536, torch.bfloat16)):
    x = (torch.randn((rows, c), generator=g) * 2 + 0.5).to(dev, dt)
    w = (torch.randn((c,), generator=g) * 0.5 + 1).to(dev)
    b = (torch.randn((c,), generator=g) * 0.5).to(dev)
    fn = lambda: layernorm.layernorm(x, w, b)
    kernels[f"K4 ({rows}, {c}) {str(dt)[6:]}"] = {"device_ms": graph_ms(fn), "b2b_ms": b2b_ms(fn)}
for rows, k, dt in ((24, 3, torch.float32), (5, 5, torch.float32), (24, 8, torch.float32),
                    (24, 3, torch.bfloat16)):
    x = torch.log_softmax(torch.randn((rows, 10000), generator=g) * 3, dim=-1).to(dev, dt)
    fn = lambda: topk.topk(x, k)
    kernels[f"K3 ({rows}, 10000) k{k} {str(dt)[6:]}"] = {
        "device_ms": graph_ms(fn), "b2b_ms": b2b_ms(fn)}

cfg = end_expansionnet_v2_coco(compute_dtype=torch.bfloat16)
cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, attention_impl="fused"))
model = init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(0)).cuda()
decode = {}
for cell, (b, beam, max_len) in (("serve", (8, 3, 20)), ("latency", (1, 5, 74))):
    args = {"beam_size": beam, "beam_max_seq_len": max_len}
    imgs = np.random.default_rng(b).integers(0, 256, (b, 384, 384, 3), dtype=np.uint8)
    cross = Captioner(model, cfg, args).forward_enc(imgs)
    for form, step_impl in (("D", "pallas_fused"), ("H", "pallas")):
        cap = Captioner(model, cfg, args, step_impl=step_impl)
        wall = breakdown.wall_ms(lambda: cap.decode(cross))
        prof = breakdown.device_profile(lambda: cap.decode(cross))
        mine = lambda key: [t for t in prof["top"] if key in t["name"]]
        decode[f"{cell} {form}"] = {
            "wall_ms": statistics.median(wall), "wall_runs_ms": wall,
            "device_ms": prof["device_ms"], "launches": prof["launches"],
            "K3": mine("topk_kernel"), "K4": mine("layernorm_"), "top": prof["top"][:6]}
print(json.dumps({"kernels": kernels, "decode": decode}))
'''


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def measure(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _MEASURE], cwd=tree, capture_output=True,
                          text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"decode_turns: {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _kernel_rows(rows) -> str:
    return ", ".join(f"{r['ms']:.3f} ms x {r['calls']}" for r in rows) or "none"


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
        runs.append({"tree": tree, **got})
        for key, r in got["kernels"].items():
            print(f"turn {i} {tree}: {key}: device {r['device_ms']:.4f} ms, back to back "
                  f"{r['b2b_ms']:.4f} ms | {card}", flush=True)
        for key, r in got["decode"].items():
            print(f"turn {i} {tree}: decode {key}: wall {r['wall_ms']:.3f} ms (runs "
                  f"{[round(t, 3) for t in r['wall_runs_ms']]}), device {r['device_ms']:.3f} "
                  f"ms, {r['launches']} launches; K3 {_kernel_rows(r['K3'])}; K4 "
                  f"{_kernel_rows(r['K4'])} | {card}", flush=True)
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).append(r)
    summary = {}
    for tree, rs in by_tree.items():
        summary[tree] = {
            "kernels_device_ms": {key: statistics.mean(r["kernels"][key]["device_ms"] for r in rs)
                                  for key in rs[0]["kernels"]},
            "decode_device_ms": {key: statistics.mean(r["decode"][key]["device_ms"] for r in rs)
                                 for key in rs[0]["decode"]},
            "decode_wall_ms": {key: statistics.mean(r["decode"][key]["wall_ms"] for r in rs)
                               for key in rs[0]["decode"]}}
        for part, means in summary[tree].items():
            print(f"{tree}: mean {part} over its turns: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in means.items()) + f" | {card}",
                  flush=True)
    line = json.dumps({"card": card, "runs": runs, "means": summary})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
