"""Data-parallel (and tensor-parallel) evaluation of the port:
`cli/evaluate.py --distributed [--n_model 2]` in two gloo processes
(tests/_torch_eval_worker.py) against the same CLI in one process and against
the JAX package's `evaluate_split` on one device and on its 4-device CPU mesh
(`make_mesh(n_data=4)`), on a corpus the test writes: 8 train, 6 val and 10
test images (in global batches of 4 the last test batch holds 2 rows, both on
data rank 0), features in (an HDF5 store of 9 to 12 tokens an image, so
batches carry encoder pads) and end to end (32 x 32 JPEGs, a tiny Swin on the
"pallas" backbone). Held: the dumped predictions and the printed scores equal
the one-process run's, rank 0 alone printing and writing them; the
predictions equal JAX's; `compute_evaluation_loss` over the data ranks within
1e-6 of one process's; `cli/train.py --distributed`'s eval hook runs on both
ranks, each on its rows, and rank 0's scores and predictions equal a
one-process hook's (the learning rate is 0, so that both evaluate the same
weights: data-parallel training is tests/test_torch_ddp.py's).
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_eval_worker as w
from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.cli import evaluate as port_cli
from on_device_image_captioning_torch.cli import train as train_cli
from on_device_image_captioning_torch.data.datasets import load_coco_karpathy
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_tpu.cli import evaluate as jax_cli
from on_device_image_captioning_tpu.data.datasets import load_coco_karpathy as jax_karpathy
from on_device_image_captioning_tpu.data.features_io import FeatureStore
from on_device_image_captioning_tpu.parallel import mesh as jpm
from test_torch_harness import captioner_pair, e2e_pair, to_jax_cap, to_jax_model
from test_torch_tensor_parallel import with_biases

FEAT_DIM, BATCH, BEAM, MAX_LEN = 24, 4, 2, 12
SPLITS = (("train", 8), ("val", 6), ("test", 10))
SCORE_LINE = re.compile(r"^(Bleu_\d|CIDEr): ")  # printed twice: by the scorer and the CLI
HEAD_FLAGS = ["--model_dim", "32", "--N_enc", "1", "--N_dec", "1", "--ff", "64",
              "--num_heads", "4", "--num_exp_enc_list", "4", "--num_exp_dec", "4",
              "--img_feature_dim", str(FEAT_DIM), "--max_seq_len", str(MAX_LEN)]
SWIN_FLAGS = ["--swin_img_size", "32", "--swin_patch_size", "4", "--swin_embed_dim", "16",
              "--swin_depths", "2", "2", "--swin_num_heads", "2", "4",
              "--swin_window_size", "4", "--swin_attention_impl", "pallas"]
RUNS = ("features", "end_to_end", "features_tp", "end_to_end_tp")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _configs(vocab):
    cap = pcfg.CaptionerConfig(
        d_model=32, N_enc=1, N_dec=1, ff=64, num_heads=4, num_exp_enc_list=(4,),
        num_exp_dec=4, vocab_size=len(vocab), max_seq_len=MAX_LEN, img_feature_dim=FEAT_DIM,
        sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
        unk_idx=vocab.unk_idx)
    swin = pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                           num_heads=(2, 4), window_size=4, attention_impl="pallas")
    e2e = pcfg.ModelConfig(swin=swin, captioner=dataclasses.replace(
        cap, img_feature_dim=swin.num_features))
    return cap, e2e


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("peval")
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "ball", "red", "runs", "jumps", "big", "small", "a", "the"]
    items, i = [], 0
    os.makedirs(root / "v" / "img")
    with FeatureStore(str(root / "f.hdf5"), "w") as store:
        for split, n in SPLITS:
            for _ in range(n):
                items.append({"cocoid": i, "filepath": "v", "filename": f"i{i}.jpg",
                              "split": split, "sentences": [
                                  {"raw": " ".join(rng.choice(words, size=5))}
                                  for _ in range(3)]})
                store.write(i, rng.standard_normal((int(rng.integers(9, 13)), FEAT_DIM),
                                                   dtype=np.float32))
                Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                    root / "v" / "img" / f"i{i}.jpg", quality=95)
                i += 1
    (root / "ann.json").write_text(json.dumps({"images": items}))
    vocab = load_coco_karpathy(str(root / "ann.json")).vocab
    assert len(vocab) % 2 == 0  # --n_model 2 cuts the vocabulary
    cap, e2e = _configs(vocab)
    head_params, head = with_biases(*captioner_pair(cap, 0), 12)
    e2e_params, e2e_model = with_biases(*e2e_pair(e2e, 1), 13, e2e)
    torch.save(head.state_dict(), root / "head.pth")
    torch.save(e2e_model.state_dict(), root / "e2e.pth")
    return {"root": root, "cap": cap, "e2e": e2e, "head_params": head_params,
            "e2e_params": e2e_params}


def _argv(corpus, run):
    root = corpus["root"]
    common = ["--annotations", str(root / "ann.json"), "--split", "test", "--beam_sizes",
              str(BEAM), "--batch_size", str(BATCH), "--metrics", "bleu", "cider",
              *HEAD_FLAGS]
    if run.startswith("features"):
        args = [*common, "--features_path", str(root / "f.hdf5"), "--load_path",
                str(root / "head.pth")]
    else:
        args = [*common, "--images_path", str(root), "--load_path", str(root / "e2e.pth"),
                *SWIN_FLAGS]
    if run.endswith("_tp"):
        args += ["--n_model", "2"]
    return args


def _train_argv(corpus, save):
    root = corpus["root"]
    return ["--annotations", str(root / "ann.json"), "--features_path", str(root / "f.hdf5"),
            *HEAD_FLAGS, "--save_path", str(save) + "/", "--batch_size", "4",
            "--num_epochs", "1", "--lr", "0", "--sched_type", "custom_warmup_anneal",
            "--warmup_iters", "1", "--eval_every_iter", "2", "--eval_beam_sizes", str(BEAM),
            "--eval_parallel_batch_size", str(BATCH), "--print_every_iter", "1",
            "--seed", "3", "--enc_drop", "0", "--dec_drop", "0", "--enc_input_drop", "0",
            "--dec_input_drop", "0", "--drop_other", "0"]


def _one_process_eval(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_cli.main([*argv, "--device", "cpu"]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(corpus):
    """Every run's outputs: the two workers', the one-process CLI's and
    JAX's evaluate_split, and the training CLI's eval hook both ways."""
    root = corpus["root"]
    (root / "runs.json").write_text(json.dumps(
        [[r, [*_argv(corpus, r), "--dump_predictions", str(root / f"{r}.dp.json")]]
         for r in RUNS]))
    cap = corpus["cap"]
    (root / "loss.json").write_text(json.dumps({
        "cfg": {k: v for k, v in dataclasses.asdict(cap).items() if k != "drop"},
        "annotations": str(root / "ann.json"), "batch_size": BATCH,
        "features": str(root / "f.hdf5")}))
    (root / "train.json").write_text(json.dumps(_train_argv(corpus, root / "dp_saves")))
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1"}
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, w.__file__, str(rank), str(port), str(root)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for rank in (0, 1)]

    # one process, and JAX, while the workers run
    one = {}
    for r in ("features", "end_to_end"):  # the _tp runs' reference too
        dump = root / f"{r}.one.json"
        one[r] = (_one_process_eval([*_argv(corpus, r), "--dump_predictions", str(dump)]),
                  json.loads(dump.read_text()))
    head = ExpansionNetV2(cap)
    head.load_state_dict(torch.load(root / "head.pth"))
    one_loss = port_cli.compute_evaluation_loss(
        head.eval(), cap, load_coco_karpathy(str(root / "ann.json")), "test", BATCH,
        str(root / "f.hdf5"))
    hook = []
    split = port_cli.evaluate_split

    def spied(*args, **kwargs):
        scores, preds = split(*args, **kwargs)
        hook.append({"scores": scores, "predictions": {str(k): v for k, v in preds.items()}})
        return scores, preds

    port_cli.evaluate_split = spied
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            assert train_cli.main([*_train_argv(corpus, root / "one_saves"),
                                   "--device", "cpu"]) == 0
    finally:
        port_cli.evaluate_split = split
    hook_out = out.getvalue()

    jds = jax_karpathy(str(root / "ann.json"))
    jax_preds = {}
    for name, mesh in (("one device", None), ("4-device mesh", jpm.make_mesh(n_data=4))):
        _, jax_preds[f"features, {name}"] = jax_cli.evaluate_split(
            corpus["head_params"], to_jax_cap(cap), jds, "test", BEAM, BATCH, MAX_LEN,
            str(root / "f.hdf5"), verbose=False, mesh=mesh, metrics=("bleu",))
    jds_e2e = jax_karpathy(str(root / "ann.json"), str(root))
    _, jax_preds["end_to_end, one device"] = jax_cli.evaluate_split(
        corpus["e2e_params"], to_jax_model(corpus["e2e"], "xla"), jds_e2e, "test", BEAM, BATCH,
        MAX_LEN, verbose=False, metrics=("bleu",))

    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("an evaluation worker did not finish within 150 s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return {"one": one, "one_loss": one_loss, "hook": hook, "hook_out": hook_out,
            "jax": jax_preds, "root": root}


def _read(root, name):
    return (root / name).read_text()


@pytest.mark.parametrize("run", RUNS)
def test_parallel_evaluate_equals_one_process(runs, run):
    root = runs["root"]
    text, want = runs["one"][run.removesuffix("_tp")]
    got = json.loads(_read(root, f"{run}.dp.json"))
    assert got == want
    assert set(got[str(BEAM)]) == {str(i) for i in range(14, 24)}
    scores = [line for line in text.splitlines() if SCORE_LINE.match(line)]
    rank0 = _read(root, f"{run}.0.out").splitlines()
    assert len(scores) == 10 and [line for line in rank0 if SCORE_LINE.match(line)] == scores
    assert any(f"on {2 // (1 + run.endswith('_tp'))} data ranks x "
               f"{1 + run.endswith('_tp')} model ranks" in line for line in rank0)
    assert _read(root, f"{run}.1.out") == ""  # rank 1 prints nothing, writes nothing
    if run.endswith("_tp"):
        assert "weights a rank holds" in "\n".join(rank0)


@pytest.mark.parametrize("which", ["features, one device", "features, 4-device mesh",
                                   "end_to_end, one device"])
def test_parallel_evaluate_equals_jax(runs, which):
    run = which.split(",")[0]
    got = json.loads(_read(runs["root"], f"{run}.dp.json"))[str(BEAM)]
    assert got == {str(k): v for k, v in runs["jax"][which].items()}


def test_parallel_eval_loss_equals_one_process(runs):
    losses = [json.loads(_read(runs["root"], f"loss.{r}.json")) for r in (0, 1)]
    assert losses[0] == losses[1]
    assert losses[0] == pytest.approx(runs["one_loss"], rel=0, abs=1e-6)


def test_train_eval_hook_runs_on_every_rank(runs):
    root = runs["root"]
    calls = [json.loads(_read(root, f"train.{r}.json")) for r in (0, 1)]
    one = runs["hook"]
    assert len(one) == len(calls[0]) == len(calls[1]) >= 1
    for mine, rest, want in zip(*calls, one):
        assert mine["grid"] == [2, 0] and rest == {"grid": [2, 1], "scores": {},
                                                  "predictions": {}}
        assert mine["scores"] == want["scores"] and want["scores"]
        assert mine["predictions"] == want["predictions"]
        assert set(want["predictions"]) == {str(i) for i in range(8, 14)}  # every val image
    printed = [line for line in _read(root, "train.0.out").splitlines()
               if line.startswith("[eval beam")]
    assert printed == [line for line in runs["hook_out"].splitlines()
                       if line.startswith("[eval beam")]
    assert "[eval beam" not in _read(root, "train.1.out")
