"""The port's evaluation CLI (`on_device_image_captioning_torch/cli/evaluate.py`)
against the JAX package's on a corpus the test writes, features in: one
model, an ensemble of two, `--quantize w8`, and `--param_config 1` / `2` on a
full 3-layer checkpoint (mirroring `test_evaluate_ensemble_and_quantized` and
`test_evaluate_param_config_surgery` of tests/test_cli_integration.py).

The same JAX parameters go to both CLIs: a native checkpoint through the JAX
package's `save_checkpoint` for the JAX CLI, a `.pth` state_dict through
`params/convert.py::captioner_state_dict` for the port's (`--device cpu`).
At fp32 the `--dump_predictions` files must be equal and the scores printed
equal; the eval loss agrees within 1e-5 relative.
"""
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.cli import evaluate as port_cli
from on_device_image_captioning_torch.params.convert import captioner_state_dict
from on_device_image_captioning_tpu.cli import evaluate as jax_cli
from on_device_image_captioning_tpu.config import CaptionerConfig
from on_device_image_captioning_tpu.data.datasets import load_coco_karpathy
from on_device_image_captioning_tpu.data.features_io import FeatureStore
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.utils.checkpointing import save_checkpoint

FEAT_DIM = 24
NUM_IMAGES = 12
SCORE_LINE = re.compile(r"^(Bleu_\d|METEOR|ROUGE_L|CIDEr|SPICE): ")


def tiny_flags(layers: int):
    return [
        "--model_dim", "32", "--N_enc", str(layers), "--N_dec", str(layers), "--ff", "64",
        "--num_heads", "4", "--num_exp_enc_list", "4", "--num_exp_dec", "4",
        "--img_feature_dim", str(FEAT_DIM),
    ]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 images of 3 random captions (6 train, 2 val, 4 test: in batches of 3
    the last test batch is padded) and a feature store of 9 to 12 tokens an
    image, so that batches carry encoder pads."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "ball", "red", "runs", "jumps", "big", "small", "a", "the"]
    items = []
    for i in range(NUM_IMAGES):
        split = "train" if i < 6 else ("val" if i < 8 else "test")
        items.append({
            "cocoid": i, "filepath": "val2014", "filename": f"img{i}.jpg", "split": split,
            "sentences": [{"raw": " ".join(rng.choice(words, size=5))} for _ in range(3)],
        })
    ann = root / "dataset_coco.json"
    ann.write_text(json.dumps({"images": items}))
    feat = root / "features.hdf5"
    with FeatureStore(str(feat), "w") as store:
        for i in range(NUM_IMAGES):
            n = int(rng.integers(9, 13))
            store.write(i, rng.standard_normal((n, FEAT_DIM), dtype=np.float32))
    ds = load_coco_karpathy(str(ann))  # the vocabulary the CLIs build
    return {"ann": str(ann), "features": str(feat), "root": root, "vocab": ds.vocab}


def cap_config(vocab, layers: int) -> CaptionerConfig:
    return CaptionerConfig(
        d_model=32, N_enc=layers, N_dec=layers, ff=64, num_heads=4, num_exp_enc_list=(4,),
        num_exp_dec=4, vocab_size=len(vocab), max_seq_len=12, img_feature_dim=FEAT_DIM,
        sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
        unk_idx=vocab.unk_idx,
    )


def write_both(tmp_path, name, params):
    """(native checkpoint for the JAX CLI, .pth state_dict for the port's) of
    the same JAX parameters."""
    native = save_checkpoint(str(tmp_path / name), params, additional_info="xe")
    pth = str(tmp_path / f"{name}.pth")
    torch.save(captioner_state_dict(jax.tree.map(np.asarray, params)), pth)
    return native, pth


def run_both(capsys, tmp_path, common, jax_paths, port_paths, extra=()):
    """Run both CLIs; returns {package: (dumped predictions, score lines,
    eval-loss lines)}."""
    out = {}
    for name, cli, paths, dev in (("jax", jax_cli, jax_paths, []),
                                  ("port", port_cli, port_paths, ["--device", "cpu"])):
        dump = tmp_path / f"{name}_preds.json"
        capsys.readouterr()
        assert cli.main([*common, "--load_path", *paths, "--dump_predictions", str(dump),
                         *extra, *dev]) == 0
        lines = capsys.readouterr().out.splitlines()
        out[name] = (json.loads(dump.read_text()),
                     [line for line in lines if SCORE_LINE.match(line)],
                     [line for line in lines if line.startswith("eval loss:")])
    return out


def common_args(corpus, layers: int, beams=("2",)):
    return [
        "--dataset", "coco", "--annotations", corpus["ann"], "--features_path",
        corpus["features"], "--split", "test", "--beam_sizes", *beams, "--batch_size", "3",
        "--max_seq_len", "12", *tiny_flags(layers),
    ]


def assert_same(out):
    preds_j, scores_j, _ = out["jax"]
    preds_p, scores_p, _ = out["port"]
    assert preds_p == preds_j
    assert all(set(per_beam) == {"8", "9", "10", "11"} for per_beam in preds_p.values())
    assert scores_p == scores_j
    assert len(scores_p) >= 9 * len(preds_p)  # five metrics, BLEU as four, printed twice


def test_evaluate_features_in_single_model(corpus, tmp_path, capsys):
    """One model, two beam sizes, all five metrics, --eval_loss: the
    predictions and scores equal the JAX CLI's; the loss of
    `compute_evaluation_loss` agrees within 1e-5 relative."""
    from on_device_image_captioning_torch import config as pconfig
    from on_device_image_captioning_torch.data.datasets import load_coco_karpathy as port_load
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2

    cfg = cap_config(corpus["vocab"], 1)
    params = jcap.captioner_init(jax.random.PRNGKey(3), cfg)
    native, pth = write_both(tmp_path, "m3", params)
    out = run_both(capsys, tmp_path, common_args(corpus, 1, ("2", "3")), [native], [pth],
                   ["--eval_loss"])
    assert_same(out)
    assert set(out["port"][0]) == {"2", "3"}
    assert len(out["port"][2]) == len(out["jax"][2]) == 1

    jds = load_coco_karpathy(corpus["ann"])
    want = jax_cli.compute_evaluation_loss(params, cfg, jds, "test", 3, corpus["features"])
    pds = port_load(corpus["ann"])
    pcfg = pconfig.CaptionerConfig(**{**dataclasses.asdict(cfg), "drop": pconfig.DropConfig()})
    model = ExpansionNetV2(pcfg)
    model.load_state_dict(torch.load(pth), strict=True)
    got = port_cli.compute_evaluation_loss(model.eval(), pcfg, pds, "test", 3, corpus["features"])
    assert np.isfinite(want)
    assert abs(got - want) <= 1e-5 * abs(want)


def test_evaluate_features_in_ensemble_and_quantized(corpus, tmp_path, capsys):
    """An ensemble of two checkpoints, then one checkpoint under --quantize w8
    (the encoder on int8 weights with bf16 activations, the decoder on the
    bf16 dequantized weights, as the JAX CLI decodes)."""
    cfg = cap_config(corpus["vocab"], 1)
    a = write_both(tmp_path, "ma", jcap.captioner_init(jax.random.PRNGKey(3), cfg))
    b = write_both(tmp_path, "mb", jcap.captioner_init(jax.random.PRNGKey(4), cfg))
    common = common_args(corpus, 1)
    assert_same(run_both(capsys, tmp_path, common, [a[0], b[0]], [a[1], b[1]]))
    assert_same(run_both(capsys, tmp_path, common, [a[0]], [a[1]], ["--quantize", "w8"]))


@pytest.mark.parametrize("param_config", [1, 2])
def test_evaluate_param_config_surgery(corpus, tmp_path, capsys, param_config):
    """--param_config 1 / 2 on a full 3-layer checkpoint: the layer-removal
    surgery at load on both sides, the same predictions; an already-reduced
    checkpoint passes through untouched."""
    full = cap_config(corpus["vocab"], 3)
    native, pth = write_both(tmp_path, "full", jcap.captioner_init(jax.random.PRNGKey(0), full))
    common = [*common_args(corpus, 3), "--param_config", str(param_config)]
    assert_same(run_both(capsys, tmp_path, common, [native], [pth]))

    from on_device_image_captioning_torch.params import surgery

    reduced = surgery.remove_layer(torch.load(pth), param_config)
    reduced_pth = str(tmp_path / "reduced.pth")
    torch.save(reduced, reduced_pth)
    capsys.readouterr()
    assert port_cli.main([*common, "--load_path", reduced_pth, "--device", "cpu",
                          "--dump_predictions", str(tmp_path / "reduced.json")]) == 0
    assert json.loads((tmp_path / "reduced.json").read_text()) == json.loads(
        (tmp_path / "port_preds.json").read_text())


def test_evaluate_refuses_missing_card(corpus, tmp_path):
    """--device cuda (the default) raises without a card rather than running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = cap_config(corpus["vocab"], 1)
    _, pth = write_both(tmp_path, "m", jcap.captioner_init(jax.random.PRNGKey(0), cfg))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_cli.main([*common_args(corpus, 1), "--load_path", pth])


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_decode_view_is_jax_dequantize_tree(corpus, mode):
    """The model the port's CLI decodes with under --quantize: the decoder's
    weight-only linears hold the JAX `dequantize_tree`'s bf16 weights, the
    encoder side and the model itself stay quantized; int8-activation
    linears stay as they are (the view is the model)."""
    from on_device_image_captioning_torch import config as pconfig
    from on_device_image_captioning_torch.deploy.quantization import (
        QuantLinear,
        load_quantized_state_dict,
    )
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
    from on_device_image_captioning_tpu.deploy import quantization as jquant

    cfg = cap_config(corpus["vocab"], 2)
    qp = jquant.quantize_tree(jcap.captioner_init(jax.random.PRNGKey(5), cfg), mode)
    pcfg = pconfig.CaptionerConfig(**{**dataclasses.asdict(cfg), "drop": pconfig.DropConfig()})
    sd = captioner_state_dict(jax.tree.map(np.asarray, qp))
    model = load_quantized_state_dict(ExpansionNetV2(pcfg), sd)
    view = port_cli.decode_view(model)
    if mode == "w8a8":
        assert view is model
        return
    want = captioner_state_dict(jax.tree.map(np.asarray, jquant.dequantize_tree(qp)))
    got = view.state_dict()
    decoder = [k for k in want if k.split(".")[0] in ("decoders", "vocab_linear",
                                                      "dec_reduce_group")]
    assert len(decoder) > 20
    for k in decoder:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert isinstance(view.encoders[0].ff.linear_1, QuantLinear)
    assert view.encoders is model.encoders
    assert isinstance(model.decoders[0].ff.linear_1, QuantLinear)
    assert isinstance(model.vocab_linear, QuantLinear)
    after = model.state_dict()
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(after[k], v, rtol=0, atol=0, msg=k)
