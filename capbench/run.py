"""Run one cell of the benchmark once.

    python3 -m capbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (`setup_s`) runs from the process's
start to the first timed request: the caches' directories, the program's
import, the kernels' builds (served from the checkout's build directory
after a cell's first run), the model and its weights drawn on the card from
the seed, and the warm-up at the cell's shapes. Then the window runs for
`--seconds`; with `--trace 1` it records the benchmark's spans and profiles
a short stretch of it, and the result line carries the cell's per-layer
metrics in place of its end-to-end ones. After the window the program's
state is freed and the plain reference checks what the window produced.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown when traced), and, last, the
compared numbers with their limits, which also end standard error. Exits
with 2, printing no result, without enough CUDA cards, and with 3 when JAX
or the JAX package was loaded.
"""
from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "on_device_image_captioning_tpu")
CACHE_DIR = "capbench_cache"  # at the checkout's root, listed in .gitignore


def cache_environment(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout; no
    library may pull in JAX."""
    base = os.path.join(root, CACHE_DIR)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def passes(numbers) -> bool:
    """Every compared number finite and at most its limit."""
    return bool(numbers) and all(math.isfinite(v) and v <= lim for _, v, lim in numbers)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from capbench.manifest import ROOT, Manifest

    cache_environment(str(ROOT))
    import torch

    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"capbench: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    from capbench.harness import LayerView, Tracer
    from capbench import trace as trace_mod

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tracer = Tracer(bool(args.trace), traffic.get("profile_iters", 4))
    entry = manifest.entry_class(traffic["entry"])(cfg, traffic, args.seed, device, tracer)
    entry.setup()
    torch.cuda.synchronize()
    setup_s = time.time() - STARTED

    res = entry.window(args.seconds)
    memory_peak = torch.cuda.max_memory_allocated(device)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None
    if args.trace:
        reduced = None
        if tracer.profiled is not None:
            reduced = trace_mod.reduce(trace_mod.export_events(tracer.profiled),
                                       tracer.profile_wall_s)
            device_info["busy_s"] = reduced["busy_s"]
            device_info["window_s"] = reduced["window_s"]
            breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
        # the iterations before the profiled stretch (all of them without one)
        before = tracer.profile_first if tracer.profiled is not None else res["iters"]
        before_s = (tracer.profile_started_s if tracer.profiled is not None
                    else res["window_s"])

        def early(spans):
            return {k: [ms for i, ms in v if i < before] for k, v in spans.items()}

        view = LayerView(
            host_ms=early(tracer.host), device_ms=early(tracer.device_ms()),
            trace=reduced, window_s=before_s,
            window_work=entry.work(0, before),
            profiled_work=entry.work(tracer.profile_first, tracer.profiled_iters),
            profiled_iters=tracer.profiled_iters)
        for m in manifest.per_layer(cell["name"]):
            value = manifest.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tracer.profiled = None
    else:
        values = dict(entry.end_to_end(res))
        values["setup_s"] = (setup_s, "s")
        for m in manifest.end_to_end(cell["name"]):
            value, unit = values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}

    entry.release()
    numbers = entry.check()
    correct = passes(numbers)

    found = loaded_forbidden()
    if found:
        print(f"capbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(correct, res, metrics, device_info, breakdown, power_limit(), numbers)
    print(json.dumps(line), flush=True)
    for name, v, lim in numbers:
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


def result_line(correct, res, metrics, device_info, breakdown, card, numbers) -> dict:
    """The result's JSON object, its compared numbers under the last key."""
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["card"] = card
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return line


if __name__ == "__main__":
    sys.exit(main())
