"""Tensor parallelism of the port over a model axis (`parallel/mesh.py`,
`parallel/tensor.py`) against the JAX package's single-device results,
mirroring tests/test_parallel.py.

The workers (tests/_torch_tp_worker.py) run on gloo in two processes (one
model group of 2) and in four (2 data ranks x 2 model ranks); the JAX side runs
here and the two meet as numpy files. Held: the features-in forward's
log-probs within 2e-5 of JAX's `forward(..., apply_log_softmax=True)` (the
tolerance of `test_tp_sharded_forward_exact`); beam search's tokens and
lengths equal to JAX's `beam_search` on both decode-step paths; the "pallas"
end-to-end encode within the fp32 stack tolerance of
tests/test_torch_models.py. In process: the rule table names the weights the
JAX `param_specs` names; on "fused" the Swin blocks stay whole; the lines a
rank prints at start; and the refusals.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_worker as w
from on_device_image_captioning_torch.config import end_expansionnet_v2_coco
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
from on_device_image_captioning_torch.parallel import mesh as pm
from on_device_image_captioning_torch.parallel.tensor import ShardedEmbedding, ShardedLinear
from on_device_image_captioning_torch.params.convert import (
    captioner_state_dict,
    state_dict_from_jax,
)
from on_device_image_captioning_tpu.config import DecodeConfig
from on_device_image_captioning_tpu.decode import beam_search as jbs
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.models import end_to_end as je2e
from on_device_image_captioning_tpu.parallel import mesh as jpm
from on_device_image_captioning_tpu.utils.image import normalize_on_device as jnormalize
from test_torch_harness import (
    captioner_pair,
    e2e_pair,
    jax_pallas_path,
    numpy_tree,
    to_jax_cap,
    to_jax_model,
)

STACK_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 through a stack of layers
WORLDS = ((2, 2), (4, 2))  # (processes, n_model)


def with_biases(params, model, seed, cfg=None):
    """(params, model) with every 1-D leaf (biases, LayerNorm parameters)
    moved off its init by N(0, 0.1) noise, the same on both sides: zero
    biases would hide a bias added once per rank or not at all. `cfg`: an
    end-to-end model's config (else a caption head)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + np.float32(0.1) * rng.standard_normal(a.shape, dtype=np.float32)
        if a.ndim == 1 else a, numpy_tree(params))
    sd = captioner_state_dict(params) if cfg is None else state_dict_from_jax(params, cfg)
    model.load_state_dict(sd, strict=True)
    return params, model


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX results and every worker's output, per world."""
    root = tmp_path_factory.mktemp("tp")
    params, model = with_biases(*captioner_pair(w.TP_CAP, 0), 10)
    torch.save(model.state_dict(), root / "cap.pt")
    e2e_params, e2e = with_biases(*e2e_pair(w.TP_E2E, 3), 11, w.TP_E2E)
    torch.save(e2e.state_dict(), root / "e2e.pt")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((8, 7, w.TP_CAP.img_feature_dim), dtype=np.float32)
    toks = rng.integers(0, w.TP_CAP.vocab_size, (8, 5)).astype(np.int32)
    pads = np.array([0, 2, 1, 0, 3, 0, 1, 2], np.int32)
    imgs = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    for name, a in (("feats", feats), ("toks", toks), ("pads", pads), ("imgs", imgs)):
        np.save(root / f"{name}.npy", a)

    env = {**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1"}
    procs = [(world, subprocess.Popen(
        [sys.executable, w.__file__, str(rank), str(world), str(n_model), str(port),
         str(root)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
        for world, n_model in WORLDS for port in [_free_port()] for rank in range(world)]

    # the JAX side while the workers run
    jc = to_jax_cap(w.TP_CAP)
    want = {"forward": np.asarray(jax.jit(
        lambda p, f, t: jcap.forward(p, jc, f, t, apply_log_softmax=True))(params, feats, toks))}
    dcfg = DecodeConfig(beam_size=w.BEAM, how_many_outputs=1, max_seq_len=w.MAX_LEN,
                        sos_idx=jc.sos_idx, eos_idx=jc.eos_idx)

    @jax.jit
    def decode(p, f, n):
        enc = jcap.forward_enc(p, jc, f, enc_num_pads=n)
        return jbs.beam_search(p, jc, enc, dcfg, enc_num_pads=n)

    res = decode(params, feats, pads)
    want["beam"] = (np.asarray(res.tokens), np.asarray(res.lengths), np.asarray(res.logprobs))
    je = to_jax_model(w.TP_E2E)
    with jax_pallas_path():
        want["encode"] = np.asarray(jax.jit(lambda p, x: je2e.forward_enc(p, je, jnormalize(x)))(
            je2e.prepare_inference_params(e2e_params, je), jnp.asarray(imgs)))

    outs = []
    try:
        for _, p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for _, p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a tensor-parallel worker did not finish within 120 s")
    for (_, p), out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = {world: [torch.load(root / f"out{world}_{r}.pt") for r in range(world)]
           for world, _ in WORLDS}
    return want, got


def _whole(outs, key):
    """The rows of every data rank (model rank 0's; each model group's ranks
    hold the same results, checked), in data-rank order."""
    parts = []
    for out in outs:
        n_data, n_model, data_rank, model_rank = out["grid"]
        lead = outs[data_rank * n_model]
        for a, b in zip(torch.utils._pytree.tree_leaves(out[key]),
                        torch.utils._pytree.tree_leaves(lead[key])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        if model_rank == 0:
            parts.append(out[key])
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p).numpy() for p in zip(*parts))
    return torch.cat(parts).numpy()


@pytest.mark.parametrize("world", [w_ for w_, _ in WORLDS])
def test_tp_forward_log_probs_match_jax(runs, world):
    want, got = runs
    assert [o["grid"][:2] for o in got[world]] == [(world // 2, 2)] * world
    np.testing.assert_allclose(_whole(got[world], "forward"), want["forward"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("impl", w.STEP_IMPLS)
@pytest.mark.parametrize("world", [w_ for w_, _ in WORLDS])
def test_tp_beam_search_tokens_equal_jax(runs, world, impl):
    want, got = runs
    toks, lens, lps = _whole(got[world], "beam_" + impl)
    w_toks, w_lens, w_lps = want["beam"]
    np.testing.assert_array_equal(lens, w_lens)
    for i in range(lens.shape[0]):  # tokens after the length are unspecified
        n = int(lens[i, 0])
        np.testing.assert_array_equal(toks[i, 0, :n], w_toks[i, 0, :n])
        np.testing.assert_allclose(lps[i, 0, :n], w_lps[i, 0, :n], **STACK_TOL)


@pytest.mark.parametrize("world", [w_ for w_, _ in WORLDS])
def test_tp_pallas_encode_matches_jax(runs, world):
    want, got = runs
    np.testing.assert_allclose(_whole(got[world], "encode"), want["encode"], **STACK_TOL)


def _jax_tags(tree):
    """Each leaf of a JAX tree filled with the port dim its JAX spec cuts:
    P(None, "model") on an (in, out) w is weight dim 0 in the port's (out,
    in) layout, P("model", None) on w dim 1, P("model") on b and
    P("model", None) on embed dim 0; -1 where the leaf is replicated."""
    P = jax.sharding.PartitionSpec

    def tag(path, leaf, spec):
        key = getattr(path[-1], "key", "")
        dim = -1
        if spec == P(None, "model") and key == "w":
            dim = 0
        elif spec == P("model", None):
            dim = 0 if key == "embed" else 1
        elif spec == P("model"):
            dim = 0
        return np.full(np.shape(leaf), dim, np.float32)

    return jax.tree_util.tree_map_with_path(tag, tree, jpm.param_specs(tree))


def _port_specs(model):
    """Parameter name -> the dim `shard_model` cuts, None where it stays
    whole: a row-parallel weight's dim 1 (its bias whole), every other cut
    weight's dim 0 (with its bias; an embedding has none)."""
    cut = {}
    for name, kind, _ in pm.model_axis_layers(model):
        cut[name + ".weight"] = 1 if kind == "row" else 0
        if kind not in ("row", "embedding"):
            cut[name + ".bias"] = 0
    return {n: cut.get(n) for n, _ in model.named_parameters()}


@pytest.mark.parametrize("what", ["captioner", "end_to_end"])
def test_rule_table_names_the_jax_rules_weights(what):
    """The port's rules cut the weights the JAX rules cut, by the
    reference's names, on the same dims (in the spirit of
    `test_param_specs_hit_tp_targets`)."""
    if what == "captioner":
        params, model = captioner_pair(w.TP_CAP, 0)
        tagged = captioner_state_dict(numpy_tree(_jax_tags(params)))
    else:
        params, model = e2e_pair(w.TP_E2E, 3)
        tagged = state_dict_from_jax(numpy_tree(_jax_tags(params)), w.TP_E2E)
    specs = _port_specs(model)
    assert set(specs) == set(tagged)
    want = {n: None if t.flatten()[0] < 0 else int(t.flatten()[0]) for n, t in tagged.items()}
    assert specs == want
    cut = {n for n, d in specs.items() if d is not None}
    assert "decoders.0.ff.linear_1.weight" in cut and "vocab_linear.bias" in cut
    assert "out_embedder.embed.weight" in cut and "decoders.0.ff.linear_2.bias" not in cut
    if what == "end_to_end":
        assert "swin_transf.layers.1.blocks.0.attn.qkv.weight" in cut


def _fake_grid(n_model=2, model_rank=0):
    """A grid with no process group: enough to cut a model (no collective
    runs until a forward)."""
    return pm.Grid(n_data=1, n_model=n_model, model_rank=model_rank)


def test_fused_backbone_stays_whole_and_head_is_cut():
    """On the "fused" path the block kernels take whole weights: every Swin
    weight stays as it is on every rank; the caption head is cut."""
    cfg = dataclasses.replace(
        w.TP_E2E, swin=dataclasses.replace(w.TP_E2E.swin, attention_impl="fused"))
    model = EndExpansionNetV2(cfg)
    whole = {n: p.clone() for n, p in model.named_parameters()}
    pm.shard_model(model, _fake_grid(model_rank=1))
    for name, p in model.named_parameters():
        if name.startswith("swin_transf."):
            torch.testing.assert_close(p, whole[name], rtol=0, atol=0)
    assert not any(isinstance(m, ShardedLinear) for m in model.swin_transf.modules())
    assert isinstance(model.vocab_linear, ShardedLinear) and model.vocab_linear.kind == "vocab"
    assert isinstance(model.out_embedder.embed, ShardedEmbedding)
    torch.testing.assert_close(model.out_embedder.embed.weight,
                               whole["out_embedder.embed.weight"][32:], rtol=0, atol=0)
    ff = model.decoders[1].ff
    assert (ff.linear_1.kind, ff.linear_2.kind) == ("column", "row")
    torch.testing.assert_close(ff.linear_2.weight, whole["decoders.1.ff.linear_2.weight"][:, 32:],
                               rtol=0, atol=0)


def test_pallas_swin_cut_by_heads():
    """On "pallas", qkv keeps the rank's heads of q, k and v, with the same
    heads of the bias table; proj and fc2 take the matching input columns."""
    model = EndExpansionNetV2(w.TP_E2E)
    whole = {n: p.clone() for n, p in model.named_parameters()}
    pm.shard_model(model, _fake_grid(model_rank=1))
    attn = model.swin_transf.layers[1].blocks[0].attn  # C = 32, 4 heads of 8
    pre = "swin_transf.layers.1.blocks.0.attn."
    assert attn.heads == 2
    rows = np.r_[16:32, 48:64, 80:96]  # heads 2, 3 of q, k, v
    torch.testing.assert_close(attn.qkv.weight, whole[pre + "qkv.weight"][rows], rtol=0, atol=0)
    torch.testing.assert_close(attn.qkv.bias, whole[pre + "qkv.bias"][rows], rtol=0, atol=0)
    torch.testing.assert_close(attn.relative_position_bias_table,
                               whole[pre + "relative_position_bias_table"][:, 2:], rtol=0, atol=0)
    torch.testing.assert_close(attn.proj.weight, whole[pre + "proj.weight"][:, 16:], rtol=0,
                               atol=0)
    torch.testing.assert_close(attn.proj.bias, whole[pre + "proj.bias"], rtol=0, atol=0)
    model.prepare_inference()
    assert attn.rel_bias_x.shape == (2, 16, 16)


def test_start_lines_name_rules_layers_and_bytes():
    """What rank 0 prints at start: the rules, the layers each cut, and the
    bytes of weights a rank holds beside the whole model's."""
    model = ExpansionNetV2(w.TP_CAP)
    whole = sum(p.numel() * 4 for p in model.parameters())
    lines = pm.shard_model(model, _fake_grid())
    held = sum(p.numel() * 4 for p in model.parameters())
    # half of: 4 FFs' linear_1 (64 x 32 + 64) and linear_2's weight (32 x
    # 64), vocab_linear (48 x 32 + 48) and the table (48 x 32); fp32
    assert whole - held == 4 * (4 * (1056 + 1024) + 792 + 768)
    assert lines == [
        "model axis: 2 ranks a model group, 1 data ranks",
        "  (^|\\.)vocab_linear$ (vocab): 1 layers (vocab_linear)",
        "  (^|\\.)out_embedder\\.embed$ (embedding): 1 layers (out_embedder.embed)",
        "  (^|\\.)ff\\.linear_1$ (column): 4 layers (encoders.0.ff.linear_1, ...)",
        "  (^|\\.)ff\\.linear_2$ (row): 4 layers (encoders.0.ff.linear_2, ...)",
        f"  weights a rank holds: {held} bytes of {whole} whole",
    ]


def test_refusals_name_their_reason(tmp_path):
    with pytest.raises(SystemExit, match="ff.linear_1's 64 output features"):
        pm.shard_model(ExpansionNetV2(w.TP_CAP), _fake_grid(n_model=3))
    with torch.device("meta"):  # Swin-L/384 + d512, V = 10000: shapes only
        big = EndExpansionNetV2(end_expansionnet_v2_coco())
    with pytest.raises(SystemExit, match=r"layers\.0\.blocks\.0\.attn\.qkv's 6 heads"):
        pm.shard_model(big, _fake_grid(n_model=4))
    with pytest.raises(SystemExit, match="vocab_linear's 10000 output features"):
        pm.shard_model(big, _fake_grid(n_model=3))
    with pytest.raises(SystemExit, match="ROADMAP A9"):
        pm.check_model_axis(2, quantize="w8")
    with pytest.raises(SystemExit, match="ROADMAP A8"):
        pm.check_model_axis(2, training=True)
    with pytest.raises(SystemExit, match="needs --distributed"):
        pm.make_grid(2)
    from on_device_image_captioning_torch.cli import evaluate as eval_cli
    from on_device_image_captioning_torch.cli import train as train_cli

    with pytest.raises(SystemExit, match="ROADMAP A9"):
        eval_cli.main(["--annotations", str(tmp_path / "none.json"), "--load_path", "x.pth",
                       "--quantize", "w8", "--n_model", "2", "--distributed", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ROADMAP A8"):
        train_cli.main(["--annotations", str(tmp_path / "none.json"), "--n_model", "2",
                        "--distributed", "--device", "cpu"])
