"""The port's `utils/profiling.py`: the JAX package's step-timer and logger
tests (tests/test_profiling.py) on the port, and the trace written by
`torch.profiler` with a span of the recorder in it (the recorder itself:
tests/test_torch_tracing.py)."""
import json
import os
import time

import torch

from on_device_image_captioning_torch.utils.profiling import (
    MetricsLogger,
    StepTimer,
    span,
    trace,
)


def test_step_timer_warmup_and_average():
    t = StepTimer(warmup=1)
    t.tick()
    for _ in range(3):
        time.sleep(0.01)
        t.tick()
    assert 0.005 < t.sec_per_iter < 0.1


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(path, stdout=False)
    logger.log(1, {"loss": 2.5})
    logger.log(2, {"loss": 2.25, "lr": 1e-4})
    logger.close()
    rows = [json.loads(line) for line in open(path)]
    assert rows[0] == {"step": 1, "loss": 2.5}
    assert rows[1]["lr"] == 1e-4


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    """`trace` writes a Chrome trace into the directory; a `span` inside it
    appears there by its name with the "odic." prefix."""
    with trace(str(tmp_path / "tb")):
        with span("step-region"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = [f for f in os.listdir(tmp_path / "tb") if f.endswith(".json")]
    assert len(files) == 1, files
    events = json.loads((tmp_path / "tb" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "odic.step-region" for e in events)
