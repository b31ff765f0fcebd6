"""On the card: one short run of each cell, at its full size, comes out
correct and reports every metric the manifest gives it."""
import json
import subprocess
import sys

import pytest

from capbench.manifest import ROOT, Manifest

CELLS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(cuda_device, cell, traced):
    out = subprocess.run(
        [sys.executable, "-m", "capbench.run", "--workload", cell, "--seed", str(2**31 + 5),
         "--seconds", "5", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    m = Manifest()
    want = m.per_layer(cell) if traced else m.end_to_end(cell)
    assert set(line["metrics"]) == {x["name"] for x in want}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", [
    ("serve_b32_beam3_L20", "control"), ("serve_b32_beam3_L20", "control_fp8"),
    ("serve_b32_beam3_L20", "altered_token"), ("features_b32", "control"),
    ("train_xe_b16", "control"), ("train_xe_b16", "half_batch")])
def test_control_and_faults_fail_at_full_size(cuda_device, cell, variant):
    """The controls and the planted faults at the cell's own size come out
    not correct."""
    from capbench.readings import readings
    from capbench.run import passes

    numbers = readings(Manifest(), cell, 2**31 + 11, 2.0, variant, cuda_device)
    assert not passes(numbers), numbers
