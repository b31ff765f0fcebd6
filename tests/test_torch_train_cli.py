"""The port's training CLI (`on_device_image_captioning_torch/cli/train.py`)
on the CPU (`--device cpu`), held to the JAX package's on the corpus and
feature store of tests/test_cli_integration.py::corpus.

- Parity, features in, every dropout 0: both CLIs start from the same
  weights (a `.pth` of the port's seeded model for the port, the same
  weights through the JAX package's `save_checkpoint` for the JAX CLI, which
  cannot read a `.pth` for a features model: ROADMAP C12) and take 12
  iterations of adam, radam, adamw, or adam over `--num_accum 2`. The losses
  they log (`--metrics_jsonl`, every iteration) agree within 1e-5 relative;
  the final checkpoints' weights, the JAX one through `params/convert.py`,
  within 1e-5 absolute (the updates are 1e-3 to 1e-2) under the Adam rule
  of `assert_adam_close` (the decoder's key bias, and a ReLU input at 0,
  held to Adam's bound instead); both checkpoints hold the same loader
  cursor.
- The JAX CLI tests `test_train_xe_then_scst_then_evaluate`,
  `test_train_end_to_end_fused_swin` and `test_train_scst_device_reward` on
  the port (the port's evaluate CLI reads the native checkpoint).
- Resume: 2 epochs straight equal 1 epoch and a resume bit for bit, with
  `--prefetch 0` and `2`; the guarded transitions (phase flip, batch size,
  a checkpoint of the other model kind) keep exactly the weights; C12 and
  C13 as the port repairs them.
- Native checkpoints in the evaluate and generate_features CLIs; remat.
"""
import json
import os

import numpy as np
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.cli import evaluate as port_eval
from on_device_image_captioning_torch.cli import generate_features as port_gen
from on_device_image_captioning_torch.cli import train as port_train
from on_device_image_captioning_torch.cli.demo import load_params
from on_device_image_captioning_torch.data.datasets import load_coco_karpathy
from on_device_image_captioning_torch.data.features_io import FeatureStore
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2, init_weights
from on_device_image_captioning_torch.params.convert import captioner_state_dict
from on_device_image_captioning_torch.train.train_step import xe_loss
from on_device_image_captioning_torch.utils import checkpointing as ckpt

FEAT_DIM = 24
NUM_IMAGES = 12
TINY_FLAGS = [
    "--model_dim", "32", "--N_enc", "1", "--N_dec", "1", "--ff", "64",
    "--num_heads", "4", "--num_exp_enc_list", "4", "--num_exp_dec", "4",
    "--img_feature_dim", str(FEAT_DIM),
]
NO_DROP = ["--enc_drop", "0", "--dec_drop", "0", "--enc_input_drop", "0",
           "--dec_input_drop", "0", "--drop_other", "0"]
SWIN_FLAGS = ["--swin_img_size", "32", "--swin_patch_size", "4", "--swin_embed_dim", "16",
              "--swin_depths", "2", "2", "--swin_num_heads", "2", "4", "--swin_window_size", "4"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_cli_integration.py::corpus: 12 images (8 train, 2 val, 2
    test) of 3 five-word captions, a store of (9, 24) features."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "ball", "red", "runs", "jumps", "big", "small", "a", "the"]
    items = []
    for i in range(NUM_IMAGES):
        split = "train" if i < 8 else ("val" if i < 10 else "test")
        items.append({"cocoid": i, "filepath": "val2014", "filename": f"img{i}.jpg",
                      "split": split,
                      "sentences": [{"raw": " ".join(rng.choice(words, size=5))}
                                    for _ in range(3)]})
    ann = root / "dataset_coco.json"
    ann.write_text(json.dumps({"images": items}))
    feat = root / "features.hdf5"
    with FeatureStore(str(feat), "w") as store:
        for i in range(NUM_IMAGES):
            store.write(i, rng.standard_normal((9, FEAT_DIM), dtype=np.float32))
    vocab = load_coco_karpathy(str(ann)).vocab
    cap = pcfg.CaptionerConfig(
        d_model=32, N_enc=1, N_dec=1, ff=64, num_heads=4, num_exp_enc_list=(4,),
        num_exp_dec=4, vocab_size=len(vocab), max_seq_len=12, img_feature_dim=FEAT_DIM,
        sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
        unk_idx=vocab.unk_idx)
    init = init_weights(ExpansionNetV2(cap), torch.Generator().manual_seed(3)).state_dict()
    pth = root / "init.pth"
    torch.save(init, pth)
    return {"ann": str(ann), "features": str(feat), "root": root, "cap": cap, "init": init,
            "pth": str(pth)}


def common(corpus, save, *extra):
    return ["--dataset", "coco", "--annotations", corpus["ann"],
            "--features_path", corpus["features"], "--save_path", str(save) + "/",
            "--batch_size", "4", "--seed", "7", "--max_seq_len", "12", *TINY_FLAGS, *extra]


def newest(save):
    payload, info = ckpt.load_most_recent(str(save))
    assert payload is not None, os.listdir(save)
    return payload, info


def losses(path):
    return [row["loss"] for row in map(json.loads, open(path))]


def assert_adam_close(got, want, init, updates, lr, atol=1e-5, outliers=2):
    """Two runs' weights after `updates` Adam updates at learning rates up to
    `lr`, from the same `init`: every element within `atol`, but where Adam
    turns a rounding difference into a difference of whole updates. The
    decoder's attention key bias has a zero gradient but for rounding (the
    softmax does not see it), so either run moves it by up to 2 x updates x
    lr; elsewhere an element whose ReLU input sits at 0 may take the other
    sign in one run (ROADMAP's ReLU-sign trap): at most `outliers` elements
    of a tensor may depart by more than `atol`, each within that bound."""
    assert got.keys() == want.keys()
    bound = 2 * updates * lr
    for k, w in want.items():
        diff = (got[k] - w).abs()
        if k.endswith("mha.Wk.bias"):
            assert (got[k] - init[k]).abs().max() <= bound, k
            assert (w - init[k]).abs().max() <= bound, k
            continue
        assert int((diff > atol).sum()) <= outliers, (k, diff.max())
        assert float(diff.max()) <= bound, (k, diff.max())


PARITY = {"adam": ("adam", "1"), "radam": ("radam", "1"), "adamw": ("adamw", "1"),
          "adam_accum2": ("adam", "2")}


@pytest.mark.parametrize("case", list(PARITY))
def test_train_cli_matches_jax(corpus, tmp_path, case):
    import jax

    from on_device_image_captioning_tpu.cli import train as jax_train
    from on_device_image_captioning_tpu.config import CaptionerConfig, DropConfig
    from on_device_image_captioning_tpu.params.torch_convert import convert_captioner, to_jax
    from on_device_image_captioning_tpu.utils import checkpointing as jckpt

    optim, accum = PARITY[case]
    lr = 1e-3
    jcap = CaptionerConfig(**{**corpus["cap"].__dict__, "drop": DropConfig()})
    jinit = jckpt.save_checkpoint(
        str(tmp_path / "jinit"),
        jax.tree.map(np.asarray, to_jax(convert_captioner(corpus["init"], jcap))),
        additional_info="init")
    args = [*NO_DROP, "--optim_type", optim, "--num_accum", accum, "--num_epochs", "2",
            "--print_every_iter", "1", "--sched_type", "custom_warmup_anneal", "--lr", str(lr),
            "--warmup_iters", "2"]
    jax_log, port_log = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    assert jax_train.main(common(corpus, tmp_path / "js", *args, "--pretrain_checkpoint", jinit,
                                 "--metrics_jsonl", jax_log)) == 0
    assert port_train.main(common(corpus, tmp_path / "ps", *args, "--pretrain_checkpoint",
                                  corpus["pth"], "--metrics_jsonl", port_log,
                                  "--device", "cpu")) == 0
    want, got = losses(jax_log), losses(port_log)
    assert len(want) == len(got) == 12
    np.testing.assert_allclose(got, want, rtol=1e-5)

    jpay = jckpt.load_most_recent(str(tmp_path / "js"))[0]
    ppay, info = newest(tmp_path / "ps")
    assert info == "xe" and ppay["step"] == jpay["step"] == 12
    assert ppay["data_loader_state"] == jpay["data_loader_state"]
    jw = captioner_state_dict(jax.tree.map(np.asarray, jpay["params"]))
    assert_adam_close(ppay["params"], jw, corpus["init"], 12 // int(accum), lr)
    if optim == "radam":  # rectified from the sixth update on: the weights moved
        assert (ppay["params"]["vocab_linear.weight"] - corpus["init"]["vocab_linear.weight"]
                ).abs().max() > 1e-4


def test_train_xe_then_scst_then_evaluate(corpus, tmp_path):
    """tests/test_cli_integration.py's test on the port: XE with a
    checkpoint, SCST resuming from it (the phase flip keeps the weights), and
    the port's evaluate CLI on the native checkpoint."""
    save = tmp_path / "saves"
    base = common(corpus, save, "--print_every_iter", "2", "--num_epochs", "1",
                  "--device", "cpu")
    assert port_train.main(base + ["--optim_type", "radam",
                                   "--sched_type", "custom_warmup_anneal"]) == 0
    assert len([f for f in os.listdir(save) if f.startswith("checkpoint_")]) == 1
    assert port_train.main(base + ["--reinforce", "--num_samples", "3",
                                   "--scst_max_len", "8"]) == 0
    path = max((os.path.join(save, f) for f in os.listdir(save) if f.startswith("checkpoint_")),
               key=os.path.getmtime)
    assert ckpt.load_checkpoint(path)["step"] == 2  # 8 images / 4, one epoch of SCST
    dump = str(tmp_path / "preds.json")
    assert port_eval.main([
        "--dataset", "coco", "--annotations", corpus["ann"], "--features_path",
        corpus["features"], "--load_path", path, "--split", "test", "--beam_sizes", "2",
        "--batch_size", "2", "--max_seq_len", "12", "--eval_loss", "--dump_predictions", dump,
        "--device", "cpu", *TINY_FLAGS]) == 0
    preds = json.load(open(dump))
    assert set(preds) == {"2"}
    assert preds["2"] and all(isinstance(v, str) for v in preds["2"].values())


def jpeg_corpus(tmp_path, n, n_train, seed, caption):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = tmp_path / "v" / "img"
    img_dir.mkdir(parents=True)
    items = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
            img_dir / f"i{i}.jpg")
        items.append({"cocoid": i, "filepath": "v", "filename": f"i{i}.jpg",
                      "split": "train" if i < n_train else "test",
                      "sentences": [{"raw": caption}] * 2})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": items}))
    return str(ann)


def test_train_end_to_end_fused_swin(tmp_path):
    """tests/test_cli_integration.py's test on the port: end-to-end XE on the
    "fused" path with a stage of depth 4."""
    ann = jpeg_corpus(tmp_path, 6, 4, 3, "a dog runs fast")
    save = tmp_path / "saves"
    assert port_train.main([
        "--dataset", "coco", "--annotations", ann, "--images_path", str(tmp_path),
        "--is_end_to_end", "--save_path", str(save) + "/", "--batch_size", "2",
        "--num_epochs", "1", "--seed", "3", "--max_seq_len", "10", "--model_dim", "32",
        "--N_enc", "1", "--N_dec", "1", "--ff", "64", "--num_heads", "4",
        "--num_exp_enc_list", "4", "--num_exp_dec", "4", "--img_feature_dim", "32",
        "--swin_img_size", "32", "--swin_patch_size", "4", "--swin_embed_dim", "16",
        "--swin_depths", "2", "4", "--swin_num_heads", "2", "4", "--swin_window_size", "4",
        "--swin_attention_impl", "fused", "--device", "cpu"]) == 0
    payload, _ = newest(save)
    assert "swin_transf.layers.1.blocks.3.mlp.fc2.weight" in payload["params"]
    assert all(bool(torch.isfinite(v).all()) for v in payload["params"].values())


def test_train_scst_device_reward(corpus, tmp_path, capsys):
    """tests/test_cli_integration.py's test on the port: SCST with the reward
    on the device (the shared-encoder step); here also the eval hook, features
    in, on val after the last iteration."""
    save = tmp_path / "saves"
    assert port_train.main(common(
        corpus, save, "--print_every_iter", "2", "--num_epochs", "1", "--reinforce",
        "--device_reward", "--num_samples", "3", "--scst_max_len", "8", "--device", "cpu",
        "--eval_every_iter", "2", "--eval_beam_sizes", "2", "--eval_parallel_batch_size",
        "2")) == 0
    payload, info = newest(save)
    assert info == "rf" and payload["step"] == 2
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[eval beam 2] {")]) == 1


@pytest.mark.parametrize("prefetch", ["0", "2"])
def test_resume_is_bit_equal(corpus, tmp_path, prefetch, capsys):
    """2 epochs straight against 1 epoch, then a resume to 2, every dropout
    0: the same losses after the resume and the same final weights, optimizer
    state and cursor, bit for bit. adam over --num_accum 2 with 3 batches an
    epoch (8 x 3 captions / 8): the save at the end of epoch 1 falls between
    two updates."""
    args = [*NO_DROP, "--optim_type", "adam", "--num_accum", "2", "--batch_size", "8",
            "--print_every_iter", "1", "--prefetch", prefetch, "--device", "cpu",
            "--sched_type", "custom_warmup_anneal", "--lr", "1e-2", "--warmup_iters", "2"]
    straight, split = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    assert port_train.main(common(corpus, tmp_path / "a", *args, "--num_epochs", "2",
                                  "--metrics_jsonl", straight)) == 0
    assert port_train.main(common(corpus, tmp_path / "b", *args, "--num_epochs", "1",
                                  "--metrics_jsonl", split)) == 0
    mid = ckpt.load_most_recent(str(tmp_path / "b"))[0]
    assert mid["opt_state"]["micro"] == 1 and mid["opt_state"]["optimizer"]["count"] == 1
    capsys.readouterr()
    assert port_train.main(common(corpus, tmp_path / "b", *args, "--num_epochs", "2",
                                  "--metrics_jsonl", split)) == 0
    assert "phase/batch-size change" not in capsys.readouterr().out
    assert losses(split) == losses(straight)  # 3 + 3 iterations against 6
    a, b = newest(tmp_path / "a")[0], newest(tmp_path / "b")[0]
    assert a["step"] == b["step"] == 6
    # the seed lists differ past the epochs run: each run makes num_epochs * 2
    # seeds, and the resumed one keeps the list it saved (as the JAX CLI does)
    sa, sb = a["data_loader_state"], b["data_loader_state"]
    assert sa["array_of_init_seed"][:2] == sb["array_of_init_seed"][:2] == [7, 8]
    assert {**sa, "array_of_init_seed": None} == {**sb, "array_of_init_seed": None}
    assert a["opt_state"]["optimizer"]["count"] == b["opt_state"]["optimizer"]["count"] == 3
    for k, w in a["params"].items():
        torch.testing.assert_close(b["params"][k], w, rtol=0, atol=0, msg=k)
    for s, t in zip(a["opt_state"]["optimizer"]["optimizer"]["state"].values(),
                    b["opt_state"]["optimizer"]["optimizer"]["state"].values()):
        for k in s:
            torch.testing.assert_close(t[k], s[k], rtol=0, atol=0)


def test_guarded_transitions(corpus, tmp_path, capsys):
    """A phase flip and a batch-size change keep exactly the weights of the
    checkpoint and nothing else (the run equals a fresh one warm-started from
    those weights); a checkpoint of the other model kind is skipped (the run
    equals one in an empty directory)."""
    args = [*NO_DROP, "--num_epochs", "1", "--device", "cpu", "--sched_type",
            "custom_warmup_anneal", "--lr", "1e-2", "--warmup_iters", "2"]
    xe = tmp_path / "xe"
    assert port_train.main(common(corpus, xe, *args)) == 0
    xe_payload, _ = newest(xe)
    weights = str(tmp_path / "xe_weights.pth")
    torch.save(xe_payload["params"], weights)

    def final(save, *extra):
        assert port_train.main(common(corpus, save, *args, *extra)) == 0
        return newest(save)[0]

    for name, extra in (("flip", ["--reinforce", "--num_samples", "3", "--scst_max_len", "8"]),
                        ("bs", ["--batch_size", "2"])):
        save = tmp_path / name
        os.makedirs(save)
        ckpt.save_checkpoint(str(save), xe_payload["params"], xe_payload["opt_state"],
                             xe_payload["step"], xe_payload["data_loader_state"], "xe",
                             epoch_it=1, batch_size=4)
        capsys.readouterr()
        got = final(save, *extra)
        assert "phase/batch-size change" in capsys.readouterr().out, name
        want = final(tmp_path / (name + "_fresh"), *extra, "--pretrain_checkpoint", weights)
        assert got["step"] == want["step"] > 0
        assert got["data_loader_state"] == want["data_loader_state"]
        for k, w in want["params"].items():
            torch.testing.assert_close(got["params"][k], w, rtol=0, atol=0, msg=(name, k))

    other = tmp_path / "other"
    e2e_like = {"swin_transf.norm.weight": torch.ones(16), **xe_payload["params"]}
    ckpt.save_checkpoint(str(other), e2e_like, None, 5, None, "xe")
    capsys.readouterr()
    got = final(other)
    assert "different model" in capsys.readouterr().out
    want = final(tmp_path / "empty")
    for k, w in want["params"].items():
        torch.testing.assert_close(got["params"][k], w, rtol=0, atol=0, msg=k)


def test_scst_max_len_against_resolved_length(corpus, tmp_path):
    """C13: without --max_seq_len the JAX CLI compares --scst_max_len with
    None and raises TypeError; the port holds it to the length it resolved
    from the dataset (27: five words, SOS, EOS and the margin of 20)."""
    from on_device_image_captioning_tpu.cli import train as jax_train

    argv = [a for a in common(corpus, tmp_path / "s") if a not in ("--max_seq_len", "12")]
    with pytest.raises(TypeError):
        jax_train.main(argv + ["--reinforce"])
    with pytest.raises(SystemExit, match="--scst_max_len 28 exceeds max_seq_len 27"):
        port_train.main(argv + ["--reinforce", "--scst_max_len", "28", "--device", "cpu"])
    assert port_train.main(argv + ["--reinforce", "--num_samples", "2", "--num_epochs", "1",
                                   "--device", "cpu"]) == 0
    assert newest(tmp_path / "s")[1] == "rf"


def test_features_run_reads_end_to_end_pth(corpus, tmp_path):
    """C12: a features-in run warm-started through --body_save_path or
    --pretrain_checkpoint from an end-to-end `.pth` takes its caption head
    (the JAX CLI converts it as an end-to-end model without a config and
    fails). Both equal a run from the caption head's own `.pth`."""
    from on_device_image_captioning_tpu.cli import train as jax_train

    swin = pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=12, depths=(2, 2),
                           num_heads=(2, 2), window_size=4)
    e2e = EndExpansionNetV2(pcfg.ModelConfig(swin=swin, captioner=corpus["cap"]))
    init_weights(e2e, torch.Generator().manual_seed(5))
    e2e_pth, head_pth = str(tmp_path / "e2e.pth"), str(tmp_path / "head.pth")
    torch.save(e2e.state_dict(), e2e_pth)
    torch.save(port_train.caption_head(e2e.state_dict()), head_pth)
    args = [*NO_DROP, "--num_epochs", "1", "--device", "cpu"]
    with pytest.raises(AttributeError):
        jax_train.main(common(corpus, tmp_path / "j", "--body_save_path", e2e_pth))
    runs = {}
    for name, flag, path in (("body", "--body_save_path", e2e_pth),
                             ("pretrain", "--pretrain_checkpoint", e2e_pth),
                             ("head", "--pretrain_checkpoint", head_pth)):
        assert port_train.main(common(corpus, tmp_path / name, *args, flag, path)) == 0
        runs[name] = newest(tmp_path / name)[0]["params"]
    for k, w in runs["head"].items():
        for name in ("body", "pretrain"):
            torch.testing.assert_close(runs[name][k], w, rtol=0, atol=0, msg=(name, k))


def test_evaluate_reads_native_checkpoint(corpus, tmp_path):
    """The evaluate CLI gives the same predictions and eval loss from a
    native checkpoint as from a `.pth` of the same weights."""
    native = ckpt.save_checkpoint(str(tmp_path / "n"), corpus["init"], None, 0, None, "xe")
    outs = {}
    for name, path in (("native", native), ("pth", corpus["pth"])):
        dump = tmp_path / f"{name}.json"
        assert port_eval.main([
            "--annotations", corpus["ann"], "--features_path", corpus["features"],
            "--load_path", path, "--split", "test", "--beam_sizes", "2", "--batch_size", "2",
            "--max_seq_len", "12", "--metrics", "bleu", "--dump_predictions", str(dump),
            "--device", "cpu", *TINY_FLAGS]) == 0
        outs[name] = json.loads(dump.read_text())
    assert outs["native"] == outs["pth"] and outs["pth"]["2"]


def test_generate_features_reads_native_checkpoint(tmp_path):
    """The generate_features CLI writes the same features from a native
    checkpoint of the end-to-end model (as `cli/train.py` saves it) as from
    the `.pth` of the same weights; `load_params` cleans a `.pth`'s DDP
    prefix and buffers and takes a native checkpoint's params."""
    ann = jpeg_corpus(tmp_path, 3, 2, 0, "a cat sits")
    cfg = pcfg.ModelConfig(
        swin=pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                             num_heads=(2, 4), window_size=4),
        captioner=pcfg.CaptionerConfig(d_model=32, N_enc=1, N_dec=1, ff=64, num_heads=4,
                                       num_exp_enc_list=(4,), num_exp_dec=4, vocab_size=12,
                                       max_seq_len=8, img_feature_dim=32, sos_idx=2, eos_idx=3,
                                       pad_idx=0, unk_idx=1))
    sd = init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(1)).state_dict()
    pth = str(tmp_path / "m.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, pth)
    native = ckpt.save_checkpoint(str(tmp_path / "n"), sd, None, 0, None, "xe")
    for path in (pth, native):
        assert load_params(path).keys() == sd.keys()
    stores = []
    for name, path in (("pth", pth), ("native", native)):
        out = str(tmp_path / f"{name}.hdf5")
        assert port_gen.main(["--annotations", ann, "--images_path", str(tmp_path),
                              "--backbone_checkpoint", path, "--output", out, "--batch_size",
                              "2", *SWIN_FLAGS, "--device", "cpu"]) == 0
        stores.append(out)
    with FeatureStore(stores[0]) as a, FeatureStore(stores[1]) as b:
        for i in range(3):
            np.testing.assert_array_equal(a.read(i), b.read(i))


def test_remat_gradients_equal(corpus):
    """--remat on a tiny "pallas" end-to-end model with Swin dropout,
    attention dropout and stochastic depth above 0: the loss and every
    gradient equal those without it bit for bit, and the generator ends in
    the same state (the recompute replays the forward's masks and leaves
    the stream where the forward left it)."""
    cfg = pcfg.ModelConfig(
        swin=pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                             num_heads=(2, 4), window_size=4, drop_rate=0.1,
                             attn_drop_rate=0.1, drop_path_rate=0.2),
        captioner=pcfg.CaptionerConfig(
            d_model=32, N_enc=1, N_dec=1, ff=64, num_heads=4, num_exp_enc_list=(4,),
            num_exp_dec=4, vocab_size=50, max_seq_len=10, img_feature_dim=32, sos_idx=2,
            eos_idx=3, pad_idx=0, unk_idx=1, drop=pcfg.DropConfig(0.1, 0.1, 0.1, 0.1, 0.1)))
    model = init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"enc_input": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "captions": torch.tensor([[2, 7, 9, 3, 0], [2, 5, 3, 0, 0]])}
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(5)
        loss = xe_loss(model, cfg, batch, gen, remat=remat)
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
                    gen.get_state()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    assert out[1][1].keys() == out[0][1].keys()
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=0, atol=0, msg=n)
    assert torch.equal(out[1][2], out[0][2])


def test_end_to_end_warm_starts_and_image_store(tmp_path):
    """End to end: --backbone_save_path (a backbone's own state_dict) with
    --body_save_path (a caption head's) equals --pretrain_checkpoint of the
    two merged; --preproc_images_hdf5 (a store of the same decoded images)
    equals the JPEGs; --param_config 1 over a 3-layer checkpoint equals a
    2-layer model from the checkpoint the surgery makes."""
    from on_device_image_captioning_torch.data.images_io import build_store
    from on_device_image_captioning_torch.params import surgery

    ann = jpeg_corpus(tmp_path, 4, 4, 7, "a big dog runs")
    head_flags = ["--model_dim", "32", "--N_dec", "1", "--ff", "64", "--num_heads", "4",
                  "--num_exp_enc_list", "4", "--num_exp_dec", "4", "--img_feature_dim", "32"]
    base = ["--annotations", ann, "--images_path", str(tmp_path), "--is_end_to_end",
            "--batch_size", "4", "--num_epochs", "1", "--seed", "3", "--max_seq_len", "8",
            "--swin_attention_impl", "pallas", "--sched_type", "custom_warmup_anneal",
            "--warmup_iters", "1", "--lr", "1e-2", "--device", "cpu", *NO_DROP, *head_flags,
            *SWIN_FLAGS]
    vocab = load_coco_karpathy(ann).vocab
    cfg = pcfg.ModelConfig(
        swin=pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                             num_heads=(2, 4), window_size=4),
        captioner=pcfg.CaptionerConfig(
            d_model=32, N_enc=3, N_dec=1, ff=64, num_heads=4, num_exp_enc_list=(4,),
            num_exp_dec=4, vocab_size=len(vocab), max_seq_len=8, img_feature_dim=32,
            sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
            unk_idx=vocab.unk_idx))
    p, q = (init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(s)).state_dict()
            for s in (11, 12))
    files = {name: str(tmp_path / f"{name}.pth") for name in
             ("backbone", "head", "merged", "reduced")}
    torch.save({k[len(port_train.SWIN):]: v for k, v in p.items()
                if k.startswith(port_train.SWIN)}, files["backbone"])
    torch.save(port_train.caption_head(q), files["head"])
    merged = {**port_train.caption_head(q), **port_train.backbone(p)}
    torch.save(merged, files["merged"])
    torch.save(surgery.remove_layer(merged, 1), files["reduced"])
    store = str(tmp_path / "images.hdf5")
    build_store(store, load_coco_karpathy(ann, str(tmp_path)).records("train"), 32,
                verbose=False)

    def final(name, *extra):
        assert port_train.main([*base, "--save_path", str(tmp_path / name) + "/", *extra]) == 0
        return newest(tmp_path / name)[0]["params"]

    want = final("merged", "--N_enc", "3", "--pretrain_checkpoint", files["merged"])
    runs = {"parts": final("parts", "--N_enc", "3", "--backbone_save_path", files["backbone"],
                           "--body_save_path", files["head"]),
            "store": final("store", "--N_enc", "3", "--pretrain_checkpoint", files["merged"],
                           "--preproc_images_hdf5", store)}
    assert (want["vocab_linear.weight"] - q["vocab_linear.weight"]).abs().max() > 1e-4
    for name, got in runs.items():
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=(name, k))
    surg = final("surgery", "--N_enc", "3", "--param_config", "1", "--pretrain_checkpoint",
                 files["merged"])
    plain = final("reduced", "--N_enc", "2", "--pretrain_checkpoint", files["reduced"])
    assert surgery.stack_depth(surg, "encoders") == 2
    assert surg.keys() == plain.keys()
    for k, v in plain.items():
        torch.testing.assert_close(surg[k], v, rtol=0, atol=0, msg=k)
