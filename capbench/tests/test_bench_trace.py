"""The trace reduction on a synthetic timeline, and the result line's keys."""
from capbench import trace
from capbench.run import result_line


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_busy_idle_and_launches():
    events = [
        ev("user_annotation", "capbench.decode", 100, 400),
        ev("cpu_op", "aten::item", 150, 200),
        # launched before the span, run inside it: not the span's
        ev("cuda_runtime", "cudaLaunchKernel", 50, 5, corr=1), ev("kernel", "k_a", 100, 50, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=2), ev("kernel", "k_b", 120, 50, 2),
        ev("kernel", "k_a", 400, 100), ev("gpu_memcpy", "copy", 600, 10),
    ]
    r = trace.reduce(events, window_s=1e-3)
    assert abs(r["busy_s"] - 180e-6) < 1e-12  # k_a and k_b overlap: 70 busy
    assert abs(r["kernel_s"] - 200e-6) < 1e-12
    assert trace.kernels_within(r, "decode") == [2]
    assert r["device_ops"][0] == ["k_a", 150e-6]
    assert r["idle_gaps"][0][0] == "aten::item"
    assert abs(r["idle_gaps"][0][1] - 230e-6) < 1e-12


def test_result_line_keys():
    line = result_line(True, {"attempted": 3, "failed": 0}, {"m": {"value": 1.0, "unit": "s"}},
                       {"platform": "gpu"}, None, "card", [("enc_rel", 0.01, 0.03)])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"enc_rel": {"value": 0.01, "limit": 0.03}}
    traced = result_line(True, {"attempted": 3, "failed": 0}, {}, {}, {"device_ops": []},
                         "card", [])
    assert "breakdown" in traced
