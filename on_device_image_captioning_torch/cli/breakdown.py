"""Where the time goes on the port's main path, on one NVIDIA card.

    python -m on_device_image_captioning_torch.cli.breakdown [--out FILE] \
        [--swin_attention_impl pallas|fused] [--stage_modes default|halves] \
        [--step_impl pallas|pallas_fused]

For each cell, serve (b8 / beam 3 / L20) and latency (b1 / beam 5 / L74), on
Swin-L/384 + the d512 captioner (V = 10000, bf16, seeded random weights), the
main path `Captioner.beam_search` is split into encode (`forward_enc`, uint8
images in) and decode (`Captioner.decode`). For each part it prints:

- wall ms: host clock around the part, synchronized at both ends, median of
  three unprofiled runs after one warm-up;
- device ms: the summed device time of every kernel, copy and fill in one
  `torch.profiler` pass over the same part;
- busy share: device ms / wall ms. The profiler slows the host side, so its
  own wall time is not used;
- device launches, and the kernels that took the most device time.

The last line is one JSON object holding all of it; `--out` writes it to a
file as well. With random weights no caption emits EOS, so every decode runs
to max_seq_len, the worst case of each cell. `--stage_modes halves` puts every
stage of the "fused" backbone path on the half-block kernels (the default is
the whole-block kernel up to a width of 384); `--step_impl pallas_fused` takes
the decode step that runs the cross-attention in the step kernel's launch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..api import Captioner
from ..config import ATTENTION_IMPLS, end_expansionnet_v2_coco
from ..decode.cache import STEP_IMPLS
from ..models.end_to_end import EndExpansionNetV2, init_weights

# cell -> (images, beam size, max_seq_len)
CELLS = {"serve": (8, 3, 20), "latency": (1, 5, 74)}
RUNS = 3
SEED = 0
TOP_KERNELS = 8


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def wall_ms(fn: Callable[[], object]) -> List[float]:
    fn()  # warm-up
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
    return times


def device_profile(fn: Callable[[], object]) -> Dict:
    """Device time, launch count and top kernels of one profiled call."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((e.key, e.self_device_time_total / 1000.0, e.count))
    rows.sort(key=lambda r: -r[1])
    return {
        "device_ms": sum(r[1] for r in rows),
        "launches": sum(r[2] for r in rows),
        "top": [{"name": n[:100], "ms": ms, "calls": c} for n, ms, c in rows[:TOP_KERNELS]],
    }


def measure_cell(captioner: Captioner, images: np.ndarray) -> Dict:
    cross = captioner.forward_enc(images)
    parts = {
        "encode": lambda: captioner.forward_enc(images),
        "decode": lambda: captioner.decode(cross),
    }
    out = {}
    for part, fn in parts.items():
        runs_ms = wall_ms(fn)
        prof = device_profile(fn)
        wall = statistics.median(runs_ms)
        out[part] = {"wall_ms": wall, "wall_runs_ms": runs_ms, **prof,
                     "busy_share": prof["device_ms"] / wall}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--swin_attention_impl", choices=ATTENTION_IMPLS, default="pallas")
    parser.add_argument("--stage_modes", choices=("default", "halves"), default="default")
    parser.add_argument("--step_impl", choices=STEP_IMPLS, default="pallas")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("breakdown: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(card, flush=True)

    cfg = end_expansionnet_v2_coco(compute_dtype=torch.bfloat16)
    cfg = dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, attention_impl=args.swin_attention_impl))
    modes = {i: "halves" for i in range(cfg.swin.num_layers)} if args.stage_modes == "halves" else None
    model = init_weights(EndExpansionNetV2(cfg, modes), torch.Generator().manual_seed(SEED))
    result = {"card": card, "swin_attention_impl": args.swin_attention_impl,
              "stage_modes": model.swin_transf.stage_modes, "step_impl": args.step_impl,
              "cells": {}}
    for cell, (b, beam, max_len) in CELLS.items():
        captioner = Captioner(model, cfg, {"beam_size": beam, "beam_max_seq_len": max_len},
                              step_impl=args.step_impl)
        images = np.random.default_rng(SEED + b).integers(
            0, 256, (b, 384, 384, 3), dtype=np.uint8)
        parts = measure_cell(captioner, images)
        result["cells"][cell] = {"batch": b, "beam": beam, "max_seq_len": max_len, **parts}
        for part, r in parts.items():
            print(f"{cell} b{b}/beam {beam}/L{max_len} {part}: wall {r['wall_ms']:.3f} ms "
                  f"(runs {[round(t, 3) for t in r['wall_runs_ms']]}), device "
                  f"{r['device_ms']:.3f} ms, busy share {r['busy_share']:.3f}, "
                  f"{r['launches']} device launches | {card}", flush=True)
            for k in r["top"]:
                print(f"    {k['ms']:9.3f} ms {k['calls']:6d} x  {k['name']}", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
