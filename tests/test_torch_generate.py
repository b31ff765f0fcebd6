"""The port's feature-generation CLI and its end-to-end evaluation against the
JAX package's CLIs on a tiny Swin and JPEGs the test writes (mirroring
`test_generate_features_and_end_to_end_evaluate` of
tests/test_cli_integration.py).

Both CLIs read the same `.pth` backbone checkpoint, in the end-to-end form
and in the Swin-official form; their feature stores agree within 1e-5
(float32) and hold float16 on disk under `--feature_dtype float16`. The
end-to-end evaluation reads a native checkpoint on the JAX side and a `.pth`
state_dict of the same parameters on the port's (`--device cpu`, both
backbone paths and both decode steps): the `--dump_predictions` files and
the scores printed are equal at fp32, the eval loss within 1e-5 relative.
"""
import dataclasses
import json

import h5py
import jax
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.cli import evaluate as port_eval
from on_device_image_captioning_torch.cli import generate_features as port_gen
from on_device_image_captioning_torch.data.features_io import FeatureStore as PortStore
from on_device_image_captioning_torch.params.convert import (
    captioner_state_dict,
    state_dict_from_jax,
    swin_state_dict,
)
from on_device_image_captioning_tpu.cli import evaluate as jax_eval
from on_device_image_captioning_tpu.cli import generate_features as jax_gen
from on_device_image_captioning_tpu.config import CaptionerConfig, ModelConfig, SwinConfig
from on_device_image_captioning_tpu.data.datasets import load_coco_karpathy
from on_device_image_captioning_tpu.data.features_io import FeatureStore
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.models import end_to_end
from on_device_image_captioning_tpu.utils.checkpointing import save_checkpoint

from test_torch_evaluate import SCORE_LINE

SWIN_FLAGS = [
    "--swin_img_size", "32", "--swin_patch_size", "4", "--swin_embed_dim", "16",
    "--swin_depths", "2", "2", "--swin_num_heads", "2", "4", "--swin_window_size", "4",
]
CAP_FLAGS = [
    "--model_dim", "32", "--N_enc", "2", "--N_dec", "2", "--ff", "64", "--num_heads", "4",
    "--num_exp_enc_list", "4", "8", "--num_exp_dec", "4",
]
NUM_IMAGES = 7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """7 JPEGs of 40 x 40 (4 train, 3 test: in batches of 2 the last batch of
    each split's walk is padded), the JAX parameters of a tiny end-to-end
    model, and both checkpoint forms of them."""
    from PIL import Image

    root = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(0)
    img_dir = root / "v" / "img"
    img_dir.mkdir(parents=True)
    words = ["a", "cat", "sits", "on", "the", "mat", "dog", "runs"]
    items = []
    for i in range(NUM_IMAGES):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
            img_dir / f"i{i}.jpg")
        items.append({
            "cocoid": i, "filepath": "v", "filename": f"i{i}.jpg",
            "split": "train" if i < 4 else "test",
            "sentences": [{"raw": " ".join(rng.choice(words, size=6))} for _ in range(2)],
        })
    ann = root / "ann.json"
    ann.write_text(json.dumps({"images": items}))
    vocab = load_coco_karpathy(str(ann)).vocab
    cfg = ModelConfig(
        swin=SwinConfig(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 4), window_size=4),
        captioner=CaptionerConfig(
            d_model=32, N_enc=2, N_dec=2, ff=64, num_heads=4, num_exp_enc_list=(4, 8),
            num_exp_dec=4, vocab_size=len(vocab), max_seq_len=12, img_feature_dim=32,
            sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
            unk_idx=vocab.unk_idx,
        ),
    )
    params = end_to_end.init(jax.random.PRNGKey(0), cfg)
    params_np = jax.tree.map(np.asarray, params)
    native = save_checkpoint(str(root / "ck"), params, additional_info="xe")
    pth = str(root / "e2e.pth")
    torch.save(state_dict_from_jax(params_np, cfg), pth)
    # the JAX CLI reads an end-to-end backbone checkpoint with the default
    # caption head: the same backbone beside the default head's weights
    head = jcap.captioner_init(jax.random.PRNGKey(1), CaptionerConfig(img_feature_dim=32))
    backbone_pth = str(root / "e2e_default_head.pth")
    torch.save({**swin_state_dict(params_np["swin"], cfg),
                **captioner_state_dict(jax.tree.map(np.asarray, head))}, backbone_pth)
    official = str(root / "swin_official.pth")
    swin_sd = swin_state_dict(params_np["swin"], cfg, prefix="")
    swin_sd["head.weight"] = torch.zeros(10, 32)  # the classifier the backbone does not read
    swin_sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16)
    torch.save({"model": swin_sd}, official)
    return {"root": root, "ann": str(ann), "cfg": cfg, "native": native, "pth": pth,
            "backbone_pth": backbone_pth, "official": official, "vocab": vocab}


@pytest.mark.parametrize("checkpoint", ["backbone_pth", "official"])
def test_generate_features_matches_jax(corpus, tmp_path, checkpoint):
    """Both CLIs over every split from the same backbone checkpoint: the
    float32 stores within 1e-5, every image written; the float16 stores hold
    float16 on disk, read back as float32, within float16 rounding."""
    base = ["--annotations", corpus["ann"], "--images_path", str(corpus["root"]),
            "--batch_size", "2", "--backbone_checkpoint", corpus[checkpoint], *SWIN_FLAGS]
    stores = {}
    for dtype in ("float32", "float16"):
        for name, cli, dev in (("jax", jax_gen, []), ("port", port_gen, ["--device", "cpu"])):
            out = str(tmp_path / f"{name}_{dtype}.hdf5")
            assert cli.main([*base, "--output", out, "--feature_dtype", dtype, *dev]) == 0
            stores[name, dtype] = out
    for dtype, tol in (("float32", 1e-5), ("float16", 2e-3)):
        with FeatureStore(stores["jax", dtype]) as want, PortStore(stores["port", dtype]) as got:
            for i in range(NUM_IMAGES):
                a, b = want.read(i), got.read(i)
                assert b.shape == (16, 32) and b.dtype == np.float32  # 4 x 4 tokens of 2 x 16
                np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
    with h5py.File(stores["port", "float16"], "r") as f:
        assert f["0_features"].dtype == np.float16
        assert len(f.keys()) == NUM_IMAGES
    with PortStore(stores["port", "float32"]) as s32, PortStore(stores["port", "float16"]) as s16:
        np.testing.assert_allclose(s16.read(3), s32.read(3), atol=2e-2, rtol=2e-2)


def test_load_backbone_forms_agree(corpus, tmp_path):
    """`_load_backbone` gives the same weights from the end-to-end state_dict,
    the Swin-official file and the backbone's own state_dict, and they are
    the JAX conversion's (`convert_swin(..., prefix="")`) transposed back."""
    from on_device_image_captioning_tpu.params.torch_convert import convert_swin

    scfg = port_eval_swin(corpus["cfg"])
    a = port_gen._load_backbone(corpus["backbone_pth"], scfg).state_dict()
    b = port_gen._load_backbone(corpus["official"], scfg).state_dict()
    own = str(tmp_path / "own.pth")
    torch.save(a, own)
    c = port_gen._load_backbone(own, scfg).state_dict()
    sd = torch.load(corpus["official"])["model"]
    jax_tree = convert_swin(sd, corpus["cfg"].swin, prefix="")
    want = swin_state_dict(jax_tree, corpus["cfg"], prefix="")
    assert set(a) == set(b) == set(c) == set(want)
    for k in want:
        for got in (a, b, c, port_gen._load_backbone(corpus["pth"], scfg).state_dict()):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def port_eval_swin(cfg):
    from on_device_image_captioning_torch import config as pconfig

    return pconfig.SwinConfig(**{**dataclasses.asdict(cfg.swin), "attention_impl": "pallas"})


def run_eval(capsys, cli, args, dump):
    capsys.readouterr()
    assert cli.main([*args, "--dump_predictions", str(dump)]) == 0
    lines = capsys.readouterr().out.splitlines()
    return (json.loads(dump.read_text()), [ln for ln in lines if SCORE_LINE.match(ln)],
            [ln for ln in lines if ln.startswith("eval loss:")])


def test_end_to_end_evaluate_matches_jax(corpus, tmp_path, capsys):
    """End-to-end evaluation, beam 2, all five metrics: the port on both
    backbone paths and both decode steps writes the JAX CLI's predictions and
    prints its scores; `compute_evaluation_loss` agrees within 1e-5."""
    from on_device_image_captioning_torch import config as pconfig
    from on_device_image_captioning_torch.data.datasets import load_coco_karpathy as port_load
    from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
    from on_device_image_captioning_torch.params.convert import load_reference_state_dict

    common = ["--annotations", corpus["ann"], "--images_path", str(corpus["root"]),
              "--split", "test", "--beam_sizes", "2", "--batch_size", "2",
              "--max_seq_len", "12", *CAP_FLAGS, *SWIN_FLAGS, "--eval_loss"]
    want = run_eval(capsys, jax_eval, [*common, "--load_path", corpus["native"]],
                    tmp_path / "jax.json")
    assert set(want[0]["2"]) == {"4", "5", "6"}
    assert len(want[1]) >= 9 and len(want[2]) == 1
    for impl, step in (("fused", "pallas"), ("pallas", "pallas_fused")):
        got = run_eval(capsys, port_eval, [
            *common, "--load_path", corpus["pth"], "--device", "cpu",
            "--swin_attention_impl", impl, "--step_impl", step], tmp_path / f"port_{impl}.json")
        assert got[0] == want[0], impl
        assert got[1] == want[1], impl
        assert len(got[2]) == 1

    jcfg = corpus["cfg"]
    jparams = end_to_end.prepare_inference_params(
        jax.tree.map(jax.numpy.asarray, jax.tree.map(np.asarray, load_params(corpus["native"]))),
        jcfg)
    loss_j = jax_eval.compute_evaluation_loss(jparams, jcfg, load_coco_karpathy(corpus["ann"],
                                              str(corpus["root"])), "test", 2)
    pcfg = pconfig.ModelConfig(
        swin=port_eval_swin(jcfg),
        captioner=pconfig.CaptionerConfig(**{**dataclasses.asdict(jcfg.captioner),
                                             "drop": pconfig.DropConfig()}))
    model = EndExpansionNetV2(pcfg)
    load_reference_state_dict(model, torch.load(corpus["pth"]))
    model.eval().prepare_inference()
    loss_p = port_eval.compute_evaluation_loss(model, pcfg, port_load(corpus["ann"],
                                               str(corpus["root"])), "test", 2)
    assert np.isfinite(loss_j)
    assert abs(loss_p - loss_j) <= 1e-5 * abs(loss_j)


def load_params(path):
    from on_device_image_captioning_tpu.utils.checkpointing import load_checkpoint

    return load_checkpoint(path)["params"]
