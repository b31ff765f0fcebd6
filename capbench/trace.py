"""The reduction of a profiled stretch to what the per-layer metrics and the
result line read: device activity, idle share, kernel counts, and the
breakdown of the top device operations and the longest idle gaps.

The stretch's profile is exported as a Chrome trace into the run's temporary
directory, read back and deleted. Device operations are the trace's
"kernel", "gpu_memcpy" and "gpu_memset" events; host ranges are the
"capbench.<span>" annotations of `harness.Tracer`. A kernel belongs to the
host range it was launched in: its runtime or driver call, found by the
trace's correlation id, not its start on the device, which may lag.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def export_events(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="capbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events: List[dict], window_s: float) -> Dict:
    """{"busy_s", "window_s", "kernel_s", "kernels": [(name, ts_us, dur_us,
    launch_ts_us)],
    "spans": {span: [(ts_us, dur_us)]}, "device_ops", "idle_gaps"}. busy_s
    is the union of the device operations' intervals; window_s the stretch's
    host-clock length."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def launch_ts(e):
        return launched.get(e.get("args", {}).get("correlation"), float(e["ts"]))

    kernels = [(e["name"], float(e["ts"]), float(e["dur"]), launch_ts(e)) for e in dev
               if e.get("cat") == "kernel"]
    merged = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    busy_us = sum(b - a for a, b in merged)
    spans: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("capbench."):
            spans.setdefault(e["name"][len("capbench."):], []).append(
                (float(e["ts"]), float(e["dur"])))
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _) in zip(merged, merged[1:])),
                  reverse=True)[:10]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    idle = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        over = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = min(over, key=lambda e: float(e["dur"]))["name"] if over else "no host op"
        idle.append([label, length * 1e-6])
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "kernel_s": sum(k[2] for k in kernels) * 1e-6,
        "kernels": kernels,
        "spans": spans,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": idle,
    }


def kernels_within(trace: Dict, span: str) -> List[int]:
    """The number of kernels launched inside each range of `span`."""
    starts = sorted(k[3] for k in trace["kernels"])
    return [bisect.bisect_right(starts, ts + dur) - bisect.bisect_left(starts, ts)
            for ts, dur in trace["spans"].get(span, [])]
