"""Each entry rehearsed end to end at a CPU's size through the program's
plain kernels, with the cell's own limits: the sound program passes, and
each fault the cell can have, and the control, come out not correct."""
import pytest
import torch

from capbench.harness import Tracer
from capbench.manifest import Manifest
from capbench.run import passes
from capbench.tests.tiny import tiny

SEED = 2**31 + 977  # seeds above 32 signed bits, as the driver's are
CELLS = ["serve_b32_beam3_L20", "train_xe_b16", "features_b32"]


def run_cell(cell, seconds=0.5, seed=SEED, **kw):
    cfg, traffic = tiny(cell)
    entry = Manifest().entry_class(traffic["entry"])(cfg, traffic, seed, "cpu", Tracer(False),
                                                      **kw)
    entry.setup()
    res = entry.window(seconds)
    entry.release()
    return entry, res, entry.check()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    entry, res, numbers = run_cell(cell)
    assert res["attempted"] > 0 and res["failed"] == 0 and res["items"] > 0
    assert passes(numbers), numbers
    work = entry.work(0, res["iters"])
    assert work["items"] == res["items"] and work["macs"] > 0 and work["bound_s"] > 0


def test_same_seed_same_work():
    _, _, a = run_cell("train_xe_b16", seconds=0.0)
    _, _, b = run_cell("train_xe_b16", seconds=0.0)
    assert a == b


@pytest.mark.parametrize("fault,fails", [
    # the half batch keeps the forward at full size: the gradient fails
    ("half_batch", {"head_grad_gap", "head_grad_gap.late"}),
    ("unchanged", {"loss_gap", "feat_tail", "update_gap"})])
def test_training_faults_are_caught(fault, fails):
    _, _, numbers = run_cell("train_xe_b16", seconds=0.0, fault=fault)
    failed = {name for name, v, lim in numbers if not v <= lim}
    assert failed & fails, numbers
    if fault == "half_batch":
        assert "feat_tail" not in failed, numbers


def test_optimizer_moving_double_is_caught(monkeypatch):
    """An optimizer step that moves every parameter twice as far fails the
    comparison with the reference RAdam fed the program's own gradient."""
    from on_device_image_captioning_torch.train.radam import RAdam

    original = RAdam.step

    @torch.no_grad()
    def double(self, closure=None):
        before = [p.clone() for g in self.param_groups for p in g["params"]]
        out = original(self, closure)
        for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
            p.add_(p - b)
        return out

    monkeypatch.setattr(RAdam, "step", double)
    _, _, numbers = run_cell("train_xe_b16", seconds=0.0)
    failed = {name for name, v, lim in numbers if not v <= lim}
    assert {"opt_gap", "opt_gap.late"} <= failed, numbers


def test_altered_served_token_is_caught():
    _, _, numbers = run_cell("serve_b32_beam3_L20", fault="altered_token")
    failed = {name for name, v, lim in numbers if not v <= lim}
    assert failed & {"lp_share", "rank_share"}, numbers


def test_late_steps_follow_the_window():
    """The training check also follows steps taken from the state the
    window left, and samples across the window where it serves."""
    entry, res, numbers = run_cell("train_xe_b16", seconds=1.0)
    names = {name for name, _, _ in numbers}
    assert {"loss_gap.late", "head_grad_gap.late", "opt_gap.late"} <= names
    assert entry.late["first"] == entry.cursor + res["iters"]
    assert passes(numbers), numbers


def test_reservoir_reaches_the_whole_window():
    """The checked requests are drawn from every request of the window, not
    its first few."""
    seen = set()
    for seed in range(SEED, SEED + 6):
        entry, res, numbers = run_cell("serve_b32_beam3_L20", seconds=1.0, seed=seed)
        assert len(entry.captured) == entry.traffic["check_requests"]
        seen |= set(entry.captured)
    assert max(seen) >= entry.traffic["check_requests"], seen


def test_altered_feature_row_is_caught(monkeypatch):
    from on_device_image_captioning_torch.cli import generate_features as gf

    original = gf.extract_features

    def altered(*args, **kw):  # each image's row written with its neighbour's features
        return original(*args, **kw).roll(1, dims=0)

    monkeypatch.setattr(gf, "extract_features", altered)
    _, _, numbers = run_cell("features_b32")
    assert not passes(numbers), numbers


def test_int8_control_fails():
    """The program's own w8a8 path in place of its stated precision. (At
    this size the backbone is too shallow for its features to separate
    reliably; the features cell's control runs on the card,
    `test_bench_card.py`.)"""
    _, _, numbers = run_cell("serve_b32_beam3_L20", quantize="w8a8")
    assert not passes(numbers), numbers


def test_fp8_reference_control_fails():
    """The reference computed in fp8, put in the training program's place."""
    from capbench.readings import readings

    cfg, traffic = tiny("train_xe_b16")
    numbers = readings(Manifest(), "train_xe_b16", SEED, 0.0, "control", torch.device("cpu"),
                       cfg, traffic)
    assert not passes(numbers), numbers
