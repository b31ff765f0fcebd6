"""The window-resident backbone's encode, checkout against checkout, in turns.

    python -m on_device_image_captioning_torch.cli.encode_turns \
        --trees PARENT . . PARENT [--max_ratio 1.5] [--out FILE]

Each tree (the root of a checkout holding `on_device_image_captioning_torch/`)
is measured in a process of its own, in the order given, so that two versions
compare on one card in one call (parent, change, change, parent). In each:
Swin-L/384 + the d512 captioner, bf16, seeded random weights, in three forms:
D = "fused" with its default stage modes, H = "fused" with every stage on the
half-block kernels, P = "pallas"; for each form, at b8 and b1 (seeded uint8
images):

- the encode (`Captioner.forward_enc`): wall ms, the median of three after a
  warm-up, and device ms, the summed device time of a `torch.profiler` pass,
  the median of PROFILED_PASSES of them (the tree's own `cli/breakdown`
  helpers; single passes read up to 0.5 ms apart at b1 and 2.4 ms at b8);
  and the attention core's device ms (every kernel whose name holds
  "window_attention"), the median of as many passes of its own;
- the bf16 backbone features (2, 144, 1536) of D and of H against P's, same
  weights and images: the relative RMS of the difference (its RMS over P's)
  and its largest absolute value. P runs no kernel of the shared product, so
  this reads the product at full depth.

With --max_ratio the second tree's relative RMS of D and of H must be at most
that many times the first tree's; the exit code is 1 otherwise. The last line
is one JSON object with every reading.
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
from on_device_image_captioning_torch.cli.breakdown import device_profile, wall_ms
from on_device_image_captioning_torch.config import end_expansionnet_v2_coco
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2, init_weights
from on_device_image_captioning_torch.utils.image import normalize_on_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
forms = {"D": ("fused", False), "H": ("fused", True), "P": ("pallas", False)}
PROFILED_PASSES = 5


def attention_ms(fn):
    """Device ms and launches of the attention core's kernels (every kernel
    of csrc/window_attention.cuh: K1, B3 and the core of B4) in one profiled
    call."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "window_attention" in e.key]
    return sum(e.self_device_time_total for e in rows) / 1000.0, sum(e.count for e in rows)


encode, feats = {}, {}
check = torch.from_numpy(
    np.random.default_rng(7).integers(0, 256, (2, 384, 384, 3), dtype=np.uint8)).cuda()
for name, (impl, halves) in forms.items():
    cfg = end_expansionnet_v2_coco(compute_dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, attention_impl=impl))
    modes = {i: "halves" for i in range(cfg.swin.num_layers)} if halves else None
    model = init_weights(EndExpansionNetV2(cfg, modes), torch.Generator().manual_seed(0)).cuda()
    cap = Captioner(model, cfg, {"beam_size": 3, "beam_max_seq_len": 20})
    for b in (8, 1):
        imgs = np.random.default_rng(100 + b).integers(0, 256, (b, 384, 384, 3), dtype=np.uint8)
        wall = wall_ms(lambda: cap.forward_enc(imgs))
        profs = [device_profile(lambda: cap.forward_enc(imgs)) for _ in range(PROFILED_PASSES)]
        attn = [attention_ms(lambda: cap.forward_enc(imgs)) for _ in range(PROFILED_PASSES)]
        encode[f"{name} b{b}"] = {"wall_ms": statistics.median(wall),
                                  "device_ms": statistics.median(p["device_ms"] for p in profs),
                                  "device_ms_passes": [p["device_ms"] for p in profs],
                                  "launches": profs[-1]["launches"], "top": profs[-1]["top"][:4],
                                  "attention_ms": statistics.median(a[0] for a in attn),
                                  "attention_calls": attn[-1][1]}
    with torch.inference_mode():
        feats[name] = model.swin_transf(normalize_on_device(check), cfg.compute_dtype).float()
    del cap, model
    torch.cuda.empty_cache()
features = {}
for name in ("D", "H"):
    diff = feats[name] - feats["P"]
    features[name] = {
        "rel_rms": float(diff.square().mean().sqrt() / feats["P"].square().mean().sqrt()),
        "max_abs": float(diff.abs().max()), "shape": list(feats["P"].shape)}
print(json.dumps({"encode": encode, "features": features}))
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
        raise RuntimeError(f"encode_turns: {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", required=True)
    parser.add_argument("--max_ratio", type=float, default=None)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    card = card_name()
    print(card, flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        got = measure(tree)
        runs.append({"tree": tree, **got})
        for key, r in got["encode"].items():
            print(f"turn {i} {tree}: encode {key}: device {r['device_ms']:.3f} ms, wall "
                  f"{r['wall_ms']:.3f} ms, {r['launches']} launches; attention core "
                  f"{r['attention_ms']:.3f} ms in {r['attention_calls']} calls | {card}",
                  flush=True)
        for key, r in got["features"].items():
            print(f"turn {i} {tree}: bf16 backbone features {key} vs P {tuple(r['shape'])}: "
                  f"relative RMS {r['rel_rms']:.4e}, max abs {r['max_abs']:.4e} | {card}",
                  flush=True)
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).append(r)
    summary = {
        tree: {key: statistics.mean(r["encode"][key]["device_ms"] for r in rs)
               for key in rs[0]["encode"]}
        for tree, rs in by_tree.items()}
    attention = {
        tree: {key: statistics.mean(r["encode"][key]["attention_ms"] for r in rs)
               for key in rs[0]["encode"]}
        for tree, rs in by_tree.items()}
    for tree, means in summary.items():
        print(f"{tree}: mean encode device ms over its turns: "
              + ", ".join(f"{k} {v:.3f}" for k, v in means.items()) + f" | {card}", flush=True)
        print(f"{tree}: mean attention-core device ms over its turns: "
              + ", ".join(f"{k} {v:.3f}" for k, v in attention[tree].items()) + f" | {card}",
              flush=True)
    ok = True
    if args.max_ratio is not None:
        base, cand = (by_tree[t][0]["features"] for t in list(by_tree)[:2])
        for name in ("D", "H"):
            ratio = cand[name]["rel_rms"] / base[name]["rel_rms"]
            ok &= ratio <= args.max_ratio
            print(f"bf16 features {name} vs P: {list(by_tree)[1]} / {list(by_tree)[0]} relative "
                  f"RMS ratio {ratio:.3f} (at most {args.max_ratio:g})", flush=True)
    line = json.dumps({"card": card, "runs": runs, "mean_device_ms": summary,
                       "mean_attention_ms": attention, "ok": ok})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
