"""Readings for the limits of `correct`: one process runs a cell's set-up,
a short window and its check on many seeds, and prints each seed's compared
numbers as a JSON line.

    python3 -m capbench.readings --workload <cell> --seconds 3 --seeds 1 2 3 \
        [--variant program|control|control_fp8|half_batch|unchanged|altered_token]

- program: the cell as it runs; its largest readings are the lower ends of
  the limits;
- control: the serving cells run the program's own int8 path (w8a8,
  `deploy/quantization.py`) in place of bf16; the training cell puts the
  reference, computed in fp8 (e4m3, one scale a tensor), in the program's
  place; its smallest readings are the upper ends;
- control_fp8 (serving): the program as it runs, its served tokens scored
  by the reference's decoder in fp8 in place of the program's log-probs;
- half_batch (training): the forward at full size, the loss and gradient
  over half of each batch (the other half's targets padded out), the mean
  taken over the rest;
- unchanged (training): the step returns with model and optimizer as they
  were;
- altered_token (serving): each served caption's third token altered as it
  is produced.

The benchmark's own runs never run this; `capbench/tests/test_bench_entries.py`
runs the same variants at a CPU's size, `test_bench_card.py` at the cells' own.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from capbench.run import cache_environment


def readings(manifest, cell_name: str, seed: int, seconds: float, variant: str, device,
             cfg=None, traffic=None, diag=None):
    """The compared numbers of one seed: [(name, value, limit)]."""
    from capbench.harness import Tracer
    from capbench.program import param_shapes
    from capbench.reference import checks

    cell = manifest.workload(cell_name)
    cfg = cfg or manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    entry_cls = manifest.entry_class(traffic["entry"])
    if traffic["entry"] == "train_xe":
        e = entry_cls(cfg, traffic, seed, device, Tracer(False),
                      fault=variant if variant in ("half_batch", "unchanged") else None)
        if variant == "control":  # the reference in fp8 in the program's place
            e.inputs()
            e.shapes = param_shapes(cfg)
            return checks.train_numbers(e.reference_steps("fp8"), e.reference_steps(),
                                        traffic["limits"], diag)
        e.setup()
        e.release()
        return e.check(diag)
    kw = {"quantize": "w8a8" if variant == "control" else None}
    if variant == "altered_token":
        kw["fault"] = variant
    e = entry_cls(cfg, traffic, seed, device, Tracer(False), **kw)
    e.setup()
    e.window(seconds)
    e.release()
    if variant == "control_fp8":
        return e.check(diag, low="fp8")
    return e.check(diag)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variant", default="program",
                   choices=("program", "control", "control_fp8", "half_batch", "unchanged",
                            "altered_token"))
    args = p.parse_args(argv)
    from capbench.manifest import ROOT, Manifest

    cache_environment(str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("capbench.readings: no CUDA card", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    for seed in args.seeds:
        t0 = time.time()
        diag = {}
        nums = readings(manifest, args.workload, seed, args.seconds, args.variant,
                        torch.device("cuda", 0), diag=diag)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "seconds": time.time() - t0,
                          "numbers": {k: v for k, v, _ in nums}, "diag": diag}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
