"""The port's pruning (`deploy/pruning.py`) and `cli/evaluate.py --load_pruned`,
against the JAX package's on the same converted tiny weights, on the CPU.

- A mirror of `tests/test_deploy.py::test_pruning_rounds_and_sparse_roundtrip`.
- Port and JAX prune the same weights: after one and after two rounds of
  0.33 the zero masks are identical (the JAX tree converted to the port's
  names), the pruned values equal, and `GLOBAL` equal; the npz round trip is
  bit-equal; the pruned model still runs.
- The tensors pruned and counted are the JAX tree's: each JAX leaf is
  tagged with its own constant, converted, and read back by name.
- `--load_pruned`: a mirror of `tests/test_cli_integration.py::
  test_evaluate_pruned_checkpoint`, and the port's CLI on its npz against the
  JAX CLI on its own, same pruned weights: predictions equal.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.cli import evaluate as port_cli
from on_device_image_captioning_torch.deploy import pruning
from on_device_image_captioning_torch.params.convert import (
    captioner_state_dict,
    state_dict_from_jax,
    w_leaf_names,
)
from on_device_image_captioning_tpu.cli import evaluate as jax_cli
from on_device_image_captioning_tpu.deploy import pruning as jpruning
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.params.surgery import flatten_with_paths

from test_torch_evaluate import cap_config, corpus, tiny_flags  # noqa: F401 (a fixture)
from test_torch_harness import TINY_CAP, TINY_E2E, captioner_pair, e2e_pair

AMOUNT = 0.33


def _pair(kind):
    """(JAX tree, its converter, port model) of the same tiny weights."""
    if kind == "end_to_end":
        params, model = e2e_pair(TINY_E2E, 40)
        return params, lambda p: state_dict_from_jax(_np(p), TINY_E2E), model
    params, model = captioner_pair(TINY_CAP, 41)
    return params, lambda p: captioner_state_dict(_np(p)), model


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_pruning_rounds_and_sparse_roundtrip(tmp_path):
    params, _, model = _pair("captioner")
    sd, names = model.state_dict(), w_leaf_names(model)
    p1 = pruning.global_l1_prune(sd, names, AMOUNT)
    rep1 = pruning.sparsity_report(p1)
    assert 0.25 < rep1["GLOBAL"] < 0.45
    p2 = pruning.global_l1_prune(p1, names, AMOUNT)
    rep2 = pruning.sparsity_report(p2)
    assert rep2["GLOBAL"] > rep1["GLOBAL"]  # rounds compound
    assert all(torch.equal(sd[k], model.state_dict()[k]) for k in sd)  # the input untouched

    path = str(tmp_path / "sparse.npz")
    pruning.save_sparse(path, p2)
    restored = pruning.load_sparse(path, model.state_dict())
    assert list(restored) == list(p2)
    for k in p2:
        assert restored[k].dtype == p2[k].dtype and torch.equal(restored[k], p2[k]), k

    # the pruned model still runs
    model.load_state_dict(restored)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((2, 7, TINY_CAP.img_feature_dim),
                                                 dtype=np.float32))
    toks = torch.from_numpy(rng.integers(0, TINY_CAP.vocab_size, (2, 6)).astype(np.int32))
    with torch.no_grad():
        out = model(feats, toks, apply_log_softmax=True)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("kind", ["end_to_end", "captioner"])
def test_prune_equals_jax(kind):
    """One and two rounds of 0.33 on the same weights: the port's zeros are
    the JAX package's zeros, its values the JAX values, GLOBAL the same."""
    params, convert, model = _pair(kind)
    sd, names = model.state_dict(), w_leaf_names(model)
    jp = params
    for rounds in (1, 2):
        jp = jpruning.global_l1_prune(jp, AMOUNT)
        sd = pruning.global_l1_prune(sd, names, AMOUNT)
        want = convert(jp)
        assert set(want) == set(sd)
        for k, t in want.items():
            assert torch.equal(sd[k] == 0, t == 0), (rounds, k)
            assert torch.equal(sd[k], t), (rounds, k)
        assert pruning.sparsity_report(sd)["GLOBAL"] == jpruning.sparsity_report(jp)["GLOBAL"]
        assert 0 < pruning.sparsity_report(sd)["GLOBAL"] < 1


@pytest.mark.parametrize("kind", ["end_to_end", "captioner"])
def test_pruned_and_counted_tensors_are_the_jax_leaves(kind):
    """Each JAX leaf filled with its own constant and converted: the port's
    pruned names are exactly the leaves whose path ends in `/w` with two or
    more dims, and the report counts exactly the JAX leaves of two or more
    dims, element for element."""
    params, convert, model = _pair(kind)
    flat, treedef = jax.tree.flatten(params)
    tagged = jax.tree.unflatten(treedef, [np.full(np.shape(a), i + 1, np.float32)
                                          for i, a in enumerate(flat)])
    leaves = list(flatten_with_paths(tagged))
    assert len(leaves) == len(flat) and all(np.size(a) for _, a in leaves)
    tags = {float(np.ravel(a)[0]): (path, np.ndim(a)) for path, a in leaves}
    sd = convert(tagged)
    source = {}
    for name, t in sd.items():
        values = torch.unique(t)
        assert values.numel() == 1, name  # one leaf a tensor
        source[name] = tags[float(values)]
    want_w = {n for n, (path, ndim) in source.items() if path.endswith("/w") and ndim >= 2}
    assert set(w_leaf_names(model)) == want_w and want_w
    counted = sum(t.numel() for t in model.state_dict().values() if t.dim() >= 2)
    jax_counted = sum(np.size(a) for _, a in leaves if np.ndim(a) >= 2)
    assert counted == jax_counted
    assert {n for n, t in model.state_dict().items() if t.dim() >= 2} == {
        n for n, (_, ndim) in source.items() if ndim >= 2}


def test_sparse_roundtrip_keeps_bf16(tmp_path):
    """A bf16 state_dict prunes, stores and loads back bit for bit."""
    _, _, model = _pair("captioner")
    sd = {k: v.bfloat16() for k, v in model.state_dict().items()}
    pruned = pruning.global_l1_prune(sd, w_leaf_names(model), 0.5)
    path = str(tmp_path / "bf16.npz")
    pruning.save_sparse(path, pruned)
    restored = pruning.load_sparse(path, sd)
    for k in pruned:
        assert restored[k].dtype == torch.bfloat16 and torch.equal(restored[k], pruned[k]), k
    assert sum(k.endswith("::idx") for k in np.load(path).files) > 0


def test_evaluate_pruned_checkpoint(corpus, tmp_path):  # noqa: F811
    """--load_pruned evaluates a sparse checkpoint (reference
    test.py:455-459), on the CPU."""
    cfg = cap_config(corpus["vocab"], 1)
    params = jcap.captioner_init(jax.random.PRNGKey(0), cfg)
    from on_device_image_captioning_torch.config import CaptionerConfig
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2

    model = ExpansionNetV2(CaptionerConfig(**{**dataclasses.asdict(cfg), "drop": TINY_CAP.drop}))
    model.load_state_dict(captioner_state_dict(_np(params)))
    pruned = pruning.global_l1_prune(model.state_dict(), w_leaf_names(model), 0.5)
    sparse_path = str(tmp_path / "pruned.npz")
    pruning.save_sparse(sparse_path, pruned)
    rc = port_cli.main(
        ["--dataset", "coco", "--annotations", corpus["ann"],
         "--features_path", corpus["features"], "--load_path", sparse_path,
         "--load_pruned", "--split", "test", "--beam_sizes", "2",
         "--batch_size", "2", "--max_seq_len", "12", *tiny_flags(1), "--device", "cpu"]
    )
    assert rc == 0


def test_evaluate_pruned_equals_jax_cli(corpus, tmp_path, capsys):  # noqa: F811
    """The port's CLI on its npz and the JAX CLI on its own npz, the same
    weights pruned by each package: the predictions are equal."""
    cfg = cap_config(corpus["vocab"], 1)
    params = jcap.captioner_init(jax.random.PRNGKey(1), cfg)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jpruning.save_sparse(jax_path, jpruning.global_l1_prune(params, 0.5))
    from on_device_image_captioning_torch.config import CaptionerConfig
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2

    model = ExpansionNetV2(CaptionerConfig(**{**dataclasses.asdict(cfg), "drop": TINY_CAP.drop}))
    model.load_state_dict(captioner_state_dict(_np(params)))
    pruning.save_sparse(port_path, pruning.global_l1_prune(
        model.state_dict(), w_leaf_names(model), 0.5))
    common = ["--dataset", "coco", "--annotations", corpus["ann"], "--features_path",
              corpus["features"], "--load_pruned", "--split", "test", "--beam_sizes", "2",
              "--batch_size", "3", "--max_seq_len", "12", *tiny_flags(1)]
    preds = {}
    for name, cli, path, extra in (("jax", jax_cli, jax_path, []),
                                   ("port", port_cli, port_path, ["--device", "cpu"])):
        dump = tmp_path / f"{name}.json"
        assert cli.main([*common, "--load_path", path, "--dump_predictions", str(dump),
                         *extra]) == 0
        preds[name] = json.loads(dump.read_text())
    assert preds["port"] == preds["jax"]
    assert set(preds["port"]["2"]) == {"8", "9", "10", "11"}
