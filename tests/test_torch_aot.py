"""The exported fixed-shape caption engine (`deploy/aot.py`) and the beam
step it unrolls (`decode/beam_search.py::_beam_step`), on the CPU at tiny
sizes.

- Mirrors of `tests/test_deploy.py::test_aot_engine_and_artifact` and
  `::test_aot_artifact_ships_serving_dtype` (the bf16 artifact's weights
  under 0.6 of the fp32 ones).
- The port's exported and reloaded engine against the JAX package's
  `deploy/aot.py::caption_fn` under `jax.jit` (on its plain XLA paths, as
  `tests/test_deploy.py` runs it), same converted weights and seeded uint8
  images, fp32:
  captions (tokens up to the length) and lengths equal, for beam 2 and
  greedy, and for weights whose output bias favours EOS so that every
  caption ends before L (there also equal to the port's eager beam search).
- The engine loaded in a fresh process that imports only
  `deploy/aot.py`, which then holds none of `models/` or `decode/`.
- The fixed-step beam search against the early-exit one, and the sync-free
  NaN rule of `ops/topk.py::topk_reference` against the JAX package's top-k
  kernel (interpret mode) on rows with NaN, infinities and ties.
"""
import ast
import copy
import dataclasses
import inspect
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.decode import beam_search as bs
from on_device_image_captioning_torch.deploy import aot
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2, init_weights
from on_device_image_captioning_torch.ops import topk as k3
from on_device_image_captioning_torch.utils.image import normalize_on_device
from on_device_image_captioning_tpu import config as jcfg
from on_device_image_captioning_tpu.deploy import aot as jaot
from on_device_image_captioning_tpu.ops.topk import topk_pallas

from test_torch_harness import REPO, TINY_E2E, e2e_pair, to_jax_model

L = 8
DCFG = pcfg.DecodeConfig(beam_size=2, how_many_outputs=1, max_seq_len=L, sos_idx=2, eos_idx=3)
# the mirrors' config: test_deploy.py's TINY_E2E (vocab 50)
SMALL = dataclasses.replace(
    TINY_E2E, captioner=dataclasses.replace(TINY_E2E.captioner, vocab_size=50))
FUSED = dataclasses.replace(
    TINY_E2E, swin=dataclasses.replace(TINY_E2E.swin, img_size=64, attention_impl="fused"))


def _model(cfg, seed=0):
    return init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(seed)).eval()


def _images(b, seed, size=32):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3), dtype=np.uint8)


def _captions(tokens, lengths):
    tokens, lengths = np.asarray(tokens), np.asarray(lengths)
    return [tokens[i, :lengths[i]].tolist() for i in range(len(lengths))]


def _eager(model, cfg, imgs, dcfg, step_impl="pallas"):
    with torch.no_grad():
        enc = model.forward_enc(normalize_on_device(torch.from_numpy(imgs)))
        res = bs.beam_search(model, cfg.captioner, enc, dcfg, dtype=cfg.compute_dtype,
                             step_impl=step_impl)
    return res.tokens[:, 0], res.lengths[:, 0]


def test_aot_engine_and_artifact(tmp_path):
    """The engine runs for its batch shape; the artifact loads and gives the
    same tokens; the fp32 model's "auto" weight dtype is float32."""
    model = _model(SMALL)
    engine, cost = aot.build_caption_engine(model, SMALL, DCFG, batch_size=2)
    assert cost == {}
    imgs = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    toks, lengths = engine(imgs)
    assert toks.shape == (2, L) and lengths.shape == (2,)

    art = str(tmp_path / "engine")
    aot.export_artifact(art, model, SMALL, DCFG, batch_size=2)
    call, params = aot.load_artifact(art)
    toks2, lengths2 = call(params, imgs)
    assert torch.equal(toks, toks2) and torch.equal(lengths, lengths2)
    manifest = aot.load_manifest(art)
    assert manifest["param_dtype"] == "float32"
    assert (manifest["batch_size"], manifest["img_size"], manifest["beam_size"],
            manifest["max_seq_len"]) == (2, 32, 2, L)
    assert aot.load_manifest(str(tmp_path)) == {}


def test_aot_artifact_ships_serving_dtype(tmp_path):
    """A bf16 engine ships bf16 weights (under 0.6 of the fp32 store), the
    manifest says so, and the loaded engine gives what an engine built over
    the same weights rounded through bf16 gives."""
    cfg16 = dataclasses.replace(SMALL, compute_dtype=torch.bfloat16)
    model = _model(cfg16)
    imgs = torch.from_numpy(_images(2, 3))
    art16, art32 = str(tmp_path / "bf16"), str(tmp_path / "stored")
    aot.export_artifact(art16, model, cfg16, DCFG, batch_size=2)  # auto = bf16
    aot.export_artifact(art32, model, cfg16, DCFG, batch_size=2, param_dtype="stored")
    assert aot.load_manifest(art16)["param_dtype"] == "bfloat16"
    assert aot.load_manifest(art32)["param_dtype"] == "stored"
    sz16, sz32 = aot.weight_bytes(art16), aot.weight_bytes(art32)
    assert sz16 < 0.6 * sz32, (sz16, sz32)

    call, params = aot.load_artifact(art16)
    assert any(t.dtype == torch.bfloat16 for t in params.values())
    assert all(t.dtype != torch.bfloat16 for t in model.state_dict().values())  # untouched
    toks, lengths = call(params, imgs)
    rounded = aot.round_to_shipped(copy.deepcopy(model), cfg16)
    direct, _ = aot.build_caption_engine(rounded, cfg16, DCFG, batch_size=2)
    toks_direct, lengths_direct = direct(imgs)
    assert torch.equal(toks, toks_direct) and torch.equal(lengths, lengths_direct)


def _jax_engine(params, cfg, dcfg, greedy, imgs):
    """JAX `caption_fn` under jit on its plain (XLA) paths, as the JAX
    package's own engine tests run it on the CPU."""
    jc = to_jax_model(cfg, attention_impl="xla")
    jd = jcfg.DecodeConfig(beam_size=dcfg.beam_size, how_many_outputs=1,
                           max_seq_len=dcfg.max_seq_len, sos_idx=dcfg.sos_idx,
                           eos_idx=dcfg.eos_idx)
    toks, lengths = jax.jit(jaot.caption_fn(jc, jd, greedy))(params, jnp.asarray(imgs))
    return np.asarray(toks), np.asarray(lengths)


def _eos_after(params, cfg, start, slope, beta):
    """The JAX tree with EOS favoured more at each step after `start`: the
    position embedding's first channel grows by `slope` a step from there,
    and the output linear reads that channel into EOS's logit with weight
    `beta` (the final LayerNorm keeps its sign)."""
    params = jax.tree.map(lambda a: a, params)
    cap = dict(params["captioner"])
    pos = cap["pos_encoder"]["embed"]
    steps = np.maximum(0.0, np.arange(pos.shape[0], dtype=np.float32) - start)
    cap["pos_encoder"] = {"embed": pos.at[:, 0].add(slope * steps)}
    vocab = dict(cap["vocab_linear"])
    vocab["w"] = vocab["w"].at[0, cfg.captioner.eos_idx].add(beta)
    cap["vocab_linear"] = vocab
    params["captioner"] = cap
    return params


def _port_model(params, cfg):
    from on_device_image_captioning_torch.params.convert import state_dict_from_jax

    model = EndExpansionNetV2(cfg)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), cfg))
    return model.eval()


@pytest.mark.parametrize("greedy", [False, True], ids=["beam2", "greedy"])
@pytest.mark.parametrize("early", [False, True], ids=["runs_to_L", "ends_early"])
def test_engine_equals_jax_caption_fn(tmp_path, greedy, early):
    """The port's exported, saved and reloaded engine against JAX's
    `caption_fn` under jit, same weights and images, fp32: captions and
    lengths equal. With the weights favouring EOS after two steps every
    caption ends before L, at different steps, and the engine also equals
    the port's eager beam search."""
    cfg = dataclasses.replace(TINY_E2E, captioner=dataclasses.replace(
        TINY_E2E.captioner, max_seq_len=L))
    params, _ = e2e_pair(cfg, 20)
    if early:
        params = _eos_after(params, cfg, start=2, slope=1.0, beta=0.5)
    model = _port_model(params, cfg)
    imgs = _images(3, 21)
    want_toks, want_len = _jax_engine(params, cfg, DCFG, greedy, imgs)
    art = str(tmp_path / "engine")
    aot.export_artifact(art, model, cfg, DCFG, batch_size=3, greedy=greedy)
    call, loaded = aot.load_artifact(art)
    toks, lengths = call(loaded, torch.from_numpy(imgs))
    assert lengths.tolist() == want_len.tolist()
    assert _captions(toks, lengths) == _captions(want_toks, want_len)
    if early:
        assert max(lengths.tolist()) < L and len(set(lengths.tolist())) > 1
        dcfg = dataclasses.replace(DCFG, beam_size=1) if greedy else DCFG
        eager_toks, eager_len = _eager(model, cfg, imgs, dcfg)
        assert torch.equal(lengths, eager_len)
        assert _captions(toks, lengths) == _captions(eager_toks, eager_len)
    else:
        assert min(lengths.tolist()) == L  # these weights emit no EOS


def test_fused_engine_equals_eager(tmp_path):
    """The window-resident backbone and the fused decode step (the card's
    form D) export, load and give the eager path's captions."""
    model = _model(FUSED, 3)
    model.prepare_inference()
    imgs = _images(2, 4, size=64)
    art = str(tmp_path / "engine")
    aot.export_artifact(art, model, FUSED, DCFG, batch_size=2, step_impl="pallas_fused")
    call, params = aot.load_artifact(art)
    toks, lengths = call(params, torch.from_numpy(imgs))
    want_toks, want_len = _eager(model, FUSED, imgs, DCFG, "pallas_fused")
    assert torch.equal(lengths, want_len)
    assert _captions(toks, lengths) == _captions(want_toks, want_len)


def test_artifact_runs_in_a_fresh_process(tmp_path):
    """A process that imports only `deploy/aot.py` loads the artifact and
    gives the same tokens, without importing `models/` or `decode/`."""
    model = _model(SMALL, 5)
    imgs = _images(2, 6)
    art = str(tmp_path / "engine")
    aot.export_artifact(art, model, SMALL, DCFG, batch_size=2)
    want = _eager(model, SMALL, imgs, DCFG)
    np.save(tmp_path / "imgs.npy", imgs)
    code = f"""
import json, sys
import numpy as np, torch
from on_device_image_captioning_torch.deploy import aot
call, params = aot.load_artifact({art!r})
toks, lengths = call(params, torch.from_numpy(np.load({str(tmp_path / 'imgs.npy')!r})))
pkg = "on_device_image_captioning_torch."
loaded = sorted(m for m in sys.modules if m.startswith((pkg + "models", pkg + "decode")))
print(json.dumps({{"tokens": toks.tolist(), "lengths": lengths.tolist(), "loaded": loaded}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert got["lengths"] == want[1].tolist()
    assert _captions(got["tokens"], got["lengths"]) == _captions(*want)


@pytest.mark.parametrize("beam", [1, 2, 3])
def test_fixed_steps_equal_early_exit(beam):
    """`fixed_beam_search` (every step, no exit test) gives the captions,
    lengths and log-probs up to the length of `beam_search`, with captions
    that end at different steps."""
    cfg = dataclasses.replace(TINY_E2E, captioner=dataclasses.replace(
        TINY_E2E.captioner, max_seq_len=12))
    params, _ = e2e_pair(cfg, 30)
    model = _port_model(_eos_after(params, cfg, start=1, slope=0.5, beta=1.0), cfg)
    dcfg = pcfg.DecodeConfig(beam_size=beam, how_many_outputs=beam, max_seq_len=12,
                             sos_idx=2, eos_idx=3)
    with torch.no_grad():
        enc = model.forward_enc(normalize_on_device(torch.from_numpy(_images(3, 31))))
        want = bs.beam_search(model, cfg.captioner, enc, dcfg)
        got = bs.fixed_beam_search(model, cfg.captioner, enc, dcfg)
    assert torch.equal(got.lengths, want.lengths)
    lengths = got.lengths.tolist()
    assert len({n for row in lengths for n in row}) > 1 and max(max(lengths)) < 12
    for i, row in enumerate(lengths):
        for j, n in enumerate(row):
            assert torch.equal(got.tokens[i, j, :n], want.tokens[i, j, :n])
            assert torch.equal(got.logprobs[i, j, :n], want.logprobs[i, j, :n])


def _nan_rows(rng, rows, width):
    """Rows of few distinct values (exact ties), with NaN, +inf and -inf
    planted at random places."""
    x = rng.choice(np.float32([-1.5, -0.25, 0.0, 0.5, 2.0]), (rows, width))
    for value, share in ((np.nan, 0.08), (np.inf, 0.04), (-np.inf, 0.1)):
        x[rng.random((rows, width)) < share] = value
    x[0] = np.nan  # every value NaN
    x[1, -1] = np.nan  # NaN last: every pick sequential
    x[2] = rng.standard_normal(width)  # no NaN
    return x.astype(np.float32)


_jit_topk = jax.jit(topk_pallas, static_argnames=("k",))


@pytest.mark.parametrize("width, k", [(4, 2), (9, 3), (25, 5), (40, 1), (40, 8), (30, 6)])
def test_topk_reference_nan_rule_equals_jax(width, k):
    """The sync-free NaN rule (one stable sort after every position up to
    the row's last NaN is made NaN) gives the JAX top-k kernel's values and
    indices on rows with NaN, infinities and ties, beam-pool wide."""
    x = _nan_rows(np.random.default_rng(width * 10 + k), 48, width)
    want_v, want_i = _jit_topk(jnp.asarray(x), k)
    got_v, got_i = k3.topk_reference(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))  # NaN == NaN


def test_topk_reference_makes_no_host_sync():
    """No `.tolist()`, `.item()`, `.nonzero()`, `int(tensor)` or
    `bool(tensor)` in the beam pool's ranking."""
    tree = ast.parse(inspect.getsource(k3.topk_reference))
    calls = [n.func for n in ast.walk(tree) if isinstance(n, ast.Call)]
    names = {f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None) for f in calls}
    assert not names & {"tolist", "item", "nonzero", "int", "bool", "float"}, names
