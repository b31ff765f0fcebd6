"""Tensor-parallel training of the port over a model axis (`parallel/mesh.py`,
`parallel/tensor.py`, `cli/train.py --n_model`) and int8 evaluation under
`--n_model`, on gloo on the CPU.

The workers (tests/_torch_tp_train_worker.py) run in four processes (2 data
ranks x 2 model ranks, part "jax") and in two (one model group, part
"port"); the JAX side and the port's one-process runs go on here while they
run, and the two meet as files. Held:

- against the JAX package: two XE steps (PlainRAdam, every dropout off) of
  the caption head and of the "pallas" end-to-end model on the 2 x 2 grid
  against the JAX `make_xe_step` on `make_mesh(n_data=2, n_model=2)` with
  `shard_train_state`: each step's loss within 2e-5 relative (as
  tests/test_torch_tensor_parallel.py holds the forward), the gathered whole
  weights within 1e-6 absolute (as tests/test_torch_ddp.py holds DDP to one
  process; the end-to-end stack within STACK_TOL) and the RAdam moments
  within the same bounds carried through the update rule (`moment_tols`).
  Every 1-D weight is moved off its init first;
- against one process of the port: dropout and stochastic depth on, one
  generator seed, the steps of `CASES` (caption head, `--num_accum 2`, the
  "pallas" model with Swin's attention and MLP dropouts, its `--remat`, the
  "fused" model with Swin whole, both SCST steps): losses within 1e-5
  relative, weights within 1e-6 absolute, the SCST samples equal. A rank
  that drew its dropout mask at its own width (`(..., ff / n)`) fails here;
- the replicated weights bit-equal across the model group after the steps,
  and the optimizer state through gather and cut back bit for bit;
- `cli/train.py --distributed --n_model 2`: one whole checkpoint, keys and
  shapes of a one-process run's; resumed at `--n_model 2` (in the workers)
  and at `--n_model 1` (here) it continues equal to an uninterrupted
  one-process run (`assert_adam_close`);
- `cli/evaluate.py --quantize w8 | w8a8 --n_model 2`: predictions equal one
  process's, at fp32.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_ddp_worker as ddp
import _torch_tp_train_worker as w
from on_device_image_captioning_torch.cli import evaluate as eval_cli
from on_device_image_captioning_torch.cli import train as cli
from on_device_image_captioning_torch.models import common as pcommon
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.models.end_to_end import init_weights
from on_device_image_captioning_torch.params.convert import (
    captioner_state_dict,
    state_dict_from_jax,
)
from on_device_image_captioning_torch.parallel import mesh as pm
from on_device_image_captioning_torch.utils import checkpointing as ckpt
from on_device_image_captioning_tpu.parallel import mesh as jpm
from on_device_image_captioning_tpu.train import radam as jradam
from on_device_image_captioning_tpu.train import train_step as jstep
from test_torch_harness import captioner_pair, e2e_pair, numpy_tree, to_jax_cap, to_jax_model
from test_torch_tensor_parallel import _fake_grid, _free_port, with_biases
from test_torch_train_cli import assert_adam_close

STACK_TOL = 1e-4  # fp32 through the end-to-end stack (tests/test_torch_train.py)
LOSS_RTOL = 2e-5
WEIGHT_ATOL = 1e-6
STEPS, ROWS, T = 2, 8, 7
TIMEOUT = 240  # seconds the workers may take


def moment_tols(weight_atol):
    """The moments' tolerances that a weight tolerance carries. PlainRAdam's
    first updates are -lr mu / (1 - b1^t), so mu is held to (1 - b1) x
    weight_atol / lr = 0.1 dg, with dg = weight_atol / lr the gradient's
    tolerance. nu = (1 - b2) sum_t g_t^2 moves by at most (1 - b2) x
    2 dg sum_t |g_t| <= 2 dg sqrt(t (1 - b2) nu): `assert_nu_close` holds
    it there (t <= 4 steps: a factor 4) above a floor of (1 - b2) dg^2."""
    dg = weight_atol / w.LR
    return {"mu": dict(rtol=0, atol=0.1 * dg), "nu": dg}


def assert_nu_close(got, want, dg, what=""):
    bound = 4 * dg * torch.sqrt(1e-3 * torch.maximum(got, want).clamp_min(0)) + 1e-3 * dg * dg
    excess = (got - want).abs() - bound
    assert float(excess.max()) <= 0, (what, float((got - want).abs().max()))


def _arrays(root):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((STEPS, ROWS, 7, w.TP_CAP.img_feature_dim), dtype=np.float32)
    pads = rng.integers(0, 4, (STEPS, ROWS)).astype(np.int32)
    caps = rng.integers(4, w.TP_CAP.vocab_size, (STEPS, ROWS, T)).astype(np.int64)
    caps[:, :, 0] = w.TP_CAP.sos_idx
    caps[:, 1::3, 5:] = w.TP_CAP.pad_idx  # right-padded captions, other counts per row
    caps[:, 2::3, 3:] = w.TP_CAP.pad_idx
    imgs = rng.standard_normal((STEPS, ROWS, 32, 32, 3)).astype(np.float32)
    for name, a in (("feats", feats), ("pads", pads), ("captions", caps), ("imgs", imgs)):
        np.save(root / f"{name}.npy", a)
    return {"feats": feats, "pads": pads, "captions": caps, "imgs": imgs}


def _jax_steps(params, cfg, arrays):
    """Two steps of the JAX `make_xe_step` on the 2 x 2 mesh (PlainRAdam,
    the train state placed by `shard_train_state`): (losses, params, mu, nu)
    in the port's names."""
    e2e = not hasattr(cfg, "sos_idx")
    jcfg = to_jax_model(cfg, attention_impl="xla") if e2e else to_jax_cap(cfg)
    mesh = jpm.make_mesh(n_data=2, n_model=2)
    opt = jradam.plain_radam(w.LR)
    state = jpm.shard_train_state(jstep.init_train_state(params, opt), mesh)
    step = jax.jit(jstep.make_xe_step(jcfg, opt, end_to_end_model=e2e))
    losses = []
    for i in range(STEPS):
        batch = {"captions": arrays["captions"][i].astype(np.int32)}
        if e2e:
            batch["enc_input"] = arrays["imgs"][i]
        else:
            batch.update(enc_input=arrays["feats"][i], enc_num_pads=arrays["pads"][i])
        state, metrics = step(state, jpm.shard_batch(batch, mesh), jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))

    def port(tree):
        tree = numpy_tree(tree)
        return state_dict_from_jax(tree, cfg) if e2e else captioner_state_dict(tree)

    def moments(node):  # the RAdamState inside the optimizer's state
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        found = [moments(c) for c in node] if isinstance(node, (tuple, list)) else []
        return next((f for f in found if f is not None), None)

    radam_state = moments(state.opt_state)
    return losses, port(state.params), port(radam_state.mu), port(radam_state.nu)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX results, the one-process runs and every worker's output."""
    root = tmp_path_factory.mktemp("tp_train")
    params, model = with_biases(*captioner_pair(w.TP_CAP, 0), 10)
    torch.save(model.state_dict(), root / "cap.pt")
    e2e_params, e2e = with_biases(*e2e_pair(w.TP_E2E, 3), 11, w.TP_E2E)
    torch.save(e2e.state_dict(), root / "e2e.pt")
    arrays = _arrays(root)
    ddp.write_corpus(root)

    env = {**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, w.__file__, str(rank), str(world), "2", str(port), str(root), part],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for part, world in (("jax", 4), ("port", 2)) for port in [_free_port()]
        for rank in range(world)]

    # while the workers run: the JAX package on the mesh, one process of the port
    jax_runs = {"cap": _jax_steps(params, w.JAX_CAP, arrays),
                "pallas": _jax_steps(e2e_params, w.JAX_E2E, arrays)}
    one = {}
    for name, (cfg, *_) in w.CASES.items():
        m = w.make_model(cfg, root)
        got = w.run_case(m, m, name, root)
        one[name] = {"loss": got["loss"], "tokens": got["tokens"],
                     "whole": dict(m.state_dict()), "opt": got["opt"].state_dict()}
    flags = w.cli_flags(root)
    assert cli.main([*flags, "--save_path", str(root / "one_saves") + "/", "--num_epochs", "2",
                     "--metrics_jsonl", str(root / "one.jsonl")]) == 0

    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a tensor-parallel training worker did not finish within {TIMEOUT} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = {part: [torch.load(root / f"{part}_{r}.pt") for r in range(world)]
           for part, world in (("jax", 4), ("port", 2))}

    # after the workers: the --n_model 2 checkpoint resumed in one process, and
    # the int8 evaluations of it in one process
    assert cli.main([*flags, "--save_path", str(root / "one_resume") + "/", "--num_epochs", "2",
                     "--metrics_jsonl", str(root / "one_resume.jsonl")]) == 0
    for scheme in ("w8", "w8a8"):
        assert eval_cli.main(w.eval_flags(root, w.checkpoint_path(root / "tp_saves"), scheme,
                                          root / f"one_{scheme}.json")) == 0
    return {"root": root, "jax": jax_runs, "one": one, "got": got}


def _close(got, want, atol, rtol=0.0, what=""):
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        torch.testing.assert_close(got[k], torch.as_tensor(v), rtol=rtol, atol=atol,
                                   msg=lambda m, k=k: f"{what} {k}: {m}")


@pytest.mark.parametrize("name", list(w.JAX_CASES))
def test_tp_xe_steps_match_jax_on_a_2x2_grid(runs, name):
    losses, params, mu, nu = runs["jax"][name]
    atol = WEIGHT_ATOL if name == "cap" else STACK_TOL
    tols = moment_tols(atol)
    for out in runs["got"]["jax"]:
        assert out["grid"][:2] == (2, 2)
        np.testing.assert_allclose(out[name]["loss"], losses, rtol=LOSS_RTOL)
        _close(out[name]["whole"], params, atol, what="weights")
        got = {k: v["mu"] for k, v in out[name]["opt"].items()}
        _close(got, mu, what="mu", **tols["mu"])
        assert {k: v["nu"] for k, v in out[name]["opt"].items()}.keys() == nu.keys()
        for k, v in nu.items():
            assert_nu_close(out[name]["opt"][k]["nu"], torch.as_tensor(v), tols["nu"], k)


@pytest.mark.parametrize("name", list(w.CASES))
def test_tp_steps_match_one_process(runs, name):
    want = runs["one"][name]
    for out in runs["got"]["port"]:
        np.testing.assert_allclose(out[name]["loss"], want["loss"], rtol=1e-5)
        _close(out[name]["whole"], want["whole"], WEIGHT_ATOL, what=name)
        if want["tokens"] is not None:
            torch.testing.assert_close(out[name]["tokens"], want["tokens"], rtol=0, atol=0)
        # the optimizer state gathered whole: one process's moments (and,
        # mid-accumulation, its summed gradients)
        got, want_opt = _flat(out[name]["opt"]), _flat(want["opt"])
        assert got.keys() == want_opt.keys()
        tols = moment_tols(WEIGHT_ATOL)
        for k, v in want_opt.items():
            leaf = k.split("/")[-1]
            if leaf == "nu":
                assert_nu_close(got[k], v, tols["nu"], k)
            elif leaf == "mu":
                torch.testing.assert_close(got[k], v, **tols["mu"], msg=k)
            else:  # mid-accumulation: the summed gradients
                assert "/grads/" in k, k
                torch.testing.assert_close(got[k], v, rtol=0, atol=tols["nu"], msg=k)


def _flat(state, prefix=""):
    """{path: tensor} of every tensor in an optimizer's state_dict."""
    if torch.is_tensor(state):
        return {prefix: state}
    items = state.items() if isinstance(state, dict) else (
        enumerate(state) if isinstance(state, list) else ())
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("part", ["jax", "port"])
def test_replicated_weights_bit_equal_across_the_model_group(runs, part):
    """After the steps, every weight a model group holds whole is the same
    on each of its ranks, bit for bit (the conjugate collectives keep the
    replicated gradients equal): no drift."""
    outs = runs["got"][part]
    cases = w.JAX_CASES if part == "jax" else w.CASES
    checked = 0
    for name in cases:
        for out in outs:
            n_data, n_model, data_rank, model_rank = out["grid"]
            lead = outs[data_rank * n_model]
            assert out[name]["own"].keys() == lead[name]["own"].keys()
            for k, v in out[name]["own"].items():
                assert torch.equal(v, lead[name]["own"][k]), (part, name, k)
                checked += model_rank > 0
    assert checked > 0


def test_optimizer_state_round_trips_bit_for_bit(runs):
    """The RAdam moments of the caption head's run, gathered whole and cut
    again, are the rank's own, bit for bit (negative zeros included)."""
    for out in runs["got"]["port"]:
        mine, back = out["round_trip"]
        leaves = [(a, b) for i in mine["state"] for a, b in
                  zip(mine["state"][i].values(), back["state"][i].values())]
        assert len(leaves) > 0
        for a, b in leaves:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_gather_of_negative_zeros_is_exact():
    """`Cut.place` fills with -0.0: the sum of the ranks' buffers is the
    whole tensor bit for bit, +0.0 and -0.0 included (a +0.0 fill turns the
    -0.0s into +0.0s, which this test tells apart)."""
    whole = torch.tensor([[1.5, -0.0], [0.0, -2.0], [-0.0, 0.0], [3.0, -0.0]])
    parts = [pm.Cut(0, torch.arange(2 * r, 2 * r + 2), (4, 2)) for r in (0, 1)]
    summed = parts[0].place(parts[0].take(whole)) + parts[1].place(parts[1].take(whole))
    assert torch.equal(summed.view(torch.int32), whole.view(torch.int32))
    plus = [torch.zeros(4, 2).index_copy_(0, c.index, c.take(whole)) for c in parts]
    assert not torch.equal((plus[0] + plus[1]).view(torch.int32), whole.view(torch.int32))


@pytest.mark.parametrize("resumed_at", [1, 2])
def test_cli_checkpoint_is_whole_and_resumes_equal(runs, resumed_at):
    """`cli/train.py --distributed --n_model 2` writes one checkpoint, whole:
    its keys and shapes, and its optimizer state's, are a one-process run's.
    Resumed at --n_model 1 (here) or 2 (in the workers), the second epoch
    equals one process's two straight epochs."""
    root = runs["root"]
    tp, info = ckpt.load_most_recent(str(root / "tp_saves"))
    one, _ = ckpt.load_most_recent(str(root / "one_saves"))
    assert info == "xe" and tp["step"] == 6 and one["step"] == 12
    assert {k: v.shape for k, v in tp["params"].items()} == {
        k: v.shape for k, v in one["params"].items()}
    shapes = [{k: tuple(v.shape) for k, v in _flat(c["opt_state"]).items()} for c in (tp, one)]
    assert shapes[0] == shapes[1] and len(shapes[0]) > 0
    save = root / ("one_resume" if resumed_at == 1 else "tp_resume")
    got, _ = ckpt.load_most_recent(str(save))
    assert got["step"] == 12
    _, cfg, store = ddp.setup(root)
    store.close()
    init = init_weights(ExpansionNetV2(cfg), torch.Generator().manual_seed(3)).state_dict()
    assert_adam_close(got["params"], one["params"], init, 12, 1e-3)
    logs = [[json.loads(line)["loss"] for line in open(root / name)]
            for name in ("one.jsonl", "one_resume.jsonl" if resumed_at == 1 else "tp2_0.jsonl")]
    np.testing.assert_allclose(logs[1], logs[0][6:], rtol=1e-5)


@pytest.mark.parametrize("scheme", ["w8", "w8a8"])
def test_int8_evaluation_over_the_model_axis_equals_one_process(runs, scheme):
    root = runs["root"]
    got, want = (json.loads((root / f"{who}_{scheme}.json").read_text()) for who in ("tp", "one"))
    assert got == want and len(want["2"]) == 2


def test_dropout_draws_the_whole_mask_and_keeps_the_ranks_part():
    """A cut activation's dropout is one process's mask, narrowed; drawing
    at the rank's own width gives another mask and moves the stream."""
    x = torch.ones(3, 8)
    whole = pcommon.dropout(x, 0.5, True, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    part = pcommon.dropout(x[:, 4:], 0.5, True, g, (-1, 4, 8))
    torch.testing.assert_close(part, whole[:, 4:], rtol=0, atol=0)
    after = torch.rand(1, generator=g)
    g2 = torch.Generator().manual_seed(0)
    own = pcommon.dropout(x[:, 4:], 0.5, True, g2)
    assert not torch.equal(own, part) and not torch.equal(torch.rand(1, generator=g2), after)


def test_training_start_lines_name_what_a_rank_holds():
    """The lines rank 0 prints at start under --n_model: the rules' layers,
    the weights' and the optimizer state's bytes a rank holds; int8 layers
    named as whole."""
    from on_device_image_captioning_torch.deploy.quantization import quantize_model
    from on_device_image_captioning_torch.train.radam import RAdam

    model = ExpansionNetV2(w.TP_CAP)
    whole = sum(p.numel() * 4 for p in model.parameters())
    lines = pm.shard_model(model, _fake_grid())
    held = sum(p.numel() * 4 for p in model.parameters())
    assert lines[-1] == f"  weights a rank holds: {held} bytes of {whole} whole"
    opt = RAdam(model.parameters(), 1e-3)
    assert cli.optimizer_state_line(opt, model) is None  # nothing allocated yet
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()  # allocates RAdam's two moments of every weight
    line = cli.optimizer_state_line(opt, model)
    assert line == f"  optimizer state a rank holds: {2 * held} bytes of {2 * whole} whole"
    assert all(p.requires_grad for p in model.parameters())
    q = ExpansionNetV2(w.TP_CAP)
    quantize_model(q, "w8")
    qlines = pm.shard_model(q, _fake_grid())
    assert any(s.startswith("  whole on every rank:") and "w_q or scale" in s for s in qlines)
