"""The host's cost of one kernel call through each way of calling it: K4
(`ops/layernorm.py`) at the decode's shape, back to back, on the card.

    python -m on_device_image_captioning_torch.cli.op_cost [--calls 2000] [--out FILE]

Forms, each the same K4 launch on the same tensors:

- "direct": the op's CUDA kernel called as a Python function (what the
  wrapper called before the kernels were ops: plan, checks, ctypes launch);
- "op": the wrapper `layernorm`, which calls the op's overload
  `torch.ops.odic.layernorm.default` (`torch.library.Library.define` and
  `impl`, the registration the port uses);
- "packet": `torch.ops.odic.layernorm(...)`, the overload resolved per call;
- "custom_op": the same kernel registered through `torch.library.custom_op`
  (in a namespace of its own, `odic_probe`, made here and used nowhere
  else).

For each shape (the decode's (24, 512) and (5, 512) fp32 rows) and form:
microseconds per call over `--calls` back-to-back calls ending in a
synchronize (host clock), the median of five rounds taken in turns. The
last line is one JSON object with every reading and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def _forms():
    from ..ops import layernorm as k4

    @torch.library.custom_op("odic_probe::layernorm", mutates_args=())
    def probe(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
        return k4._layernorm_cuda(x, weight, bias, eps)

    @probe.register_fake
    def _(x, weight, bias, eps):
        return x.new_empty(x.shape)

    return {
        "direct": lambda x, w, b: k4._layernorm_cuda(x, w, b, 1e-5),
        "op": lambda x, w, b: k4.layernorm(x, w, b, 1e-5),
        "packet": lambda x, w, b: torch.ops.odic.layernorm(x, w, b, 1e-5),
        "custom_op": lambda x, w, b: probe(x, w, b, 1e-5),
    }


def _us_per_call(fn, args, calls: int) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - start) / calls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("op_cost: no CUDA card available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    forms = _forms()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    result = {"card": card, "torch": torch.__version__, "calls": args.calls, "us_per_call": {}}
    for rows in (24, 5):
        x = torch.randn((rows, 512), generator=g).to(dev)
        w, b = torch.randn(512, generator=g).to(dev), torch.randn(512, generator=g).to(dev)
        want = forms["direct"](x, w, b)
        for name, fn in forms.items():  # warm up, and every form gives the same bits
            if not torch.equal(fn(x, w, b), want):
                raise AssertionError(f"op_cost: form {name} differs from the direct call")
        reads = {name: [] for name in forms}
        for _ in range(args.rounds):
            for name, fn in forms.items():
                reads[name].append(_us_per_call(fn, (x, w, b), args.calls))
        med = {name: statistics.median(v) for name, v in reads.items()}
        result["us_per_call"][f"({rows}, 512) fp32"] = {"median": med, "rounds": reads}
        print(f"K4 ({rows}, 512) fp32, us per call back to back (median of {args.rounds} rounds "
              f"of {args.calls}): " + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
              + f" | {card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
