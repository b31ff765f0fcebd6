"""Worker of tests/test_torch_ddp.py (not a test module): one rank of a
two-process data-parallel run of the port on gloo, on the CPU.

    python tests/_torch_ddp_worker.py <rank> <port> <corpus dir>

The rank joins the process group from the environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, as `parallel/mesh.py::init_distributed` reads
them), takes its loader shard of the global batch of 4 (2 rows) and runs,
through `DataParallel`: an XE step, then a shared-encoder SCST step with the
reward on the device, the sampler's Gumbel noise its rows of the whole
batch's. It saves the loss and the weights after each step to
<corpus dir>/rank<r>.pt; then it runs `cli/train.py --distributed` for an
epoch into <corpus dir>/cli_saves/. The helpers below build the corpus, the
model and the batches the same way for the test's one-process reference.
"""
import json
import os
import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from on_device_image_captioning_torch import config as pcfg  # noqa: E402
from on_device_image_captioning_torch.data.datasets import load_coco_karpathy  # noqa: E402
from on_device_image_captioning_torch.data.loader import ShardedCaptionLoader  # noqa: E402

FEAT_DIM = 8
SEED, LR, N_SAMPLES, SCST_LEN = 5, 1e-2, 2, 6
WORDS = ["cat", "dog", "ball", "red", "runs", "jumps", "big", "small", "a", "the"]
CLI_FLAGS = ["--model_dim", "32", "--N_enc", "1", "--N_dec", "1", "--ff", "64",
             "--num_heads", "4", "--num_exp_enc_list", "4", "--num_exp_dec", "4",
             "--img_feature_dim", str(FEAT_DIM), "--enc_drop", "0", "--dec_drop", "0",
             "--enc_input_drop", "0", "--dec_input_drop", "0", "--drop_other", "0",
             "--batch_size", "4", "--max_seq_len", "12", "--num_epochs", "1",
             "--print_every_iter", "1", "--optim_type", "adam", "--sched_type",
             "custom_warmup_anneal", "--lr", "1e-3", "--warmup_iters", "2", "--seed", "3",
             "--device", "cpu"]


def write_corpus(root):
    """8 train images of 3 captions of 2 to 9 words (the rows' pads differ)
    and 2 val ones, a store of 5 to 8 feature rows an image."""
    from on_device_image_captioning_torch.data.features_io import FeatureStore

    rng = np.random.default_rng(0)
    items = [{"cocoid": i, "filepath": "v", "filename": f"{i}.jpg",
              "split": "train" if i < 8 else "val",
              "sentences": [{"raw": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 10))))}
                            for _ in range(3)]} for i in range(10)]
    (root / "ann.json").write_text(json.dumps({"images": items}))
    with FeatureStore(str(root / "f.hdf5"), "w") as store:
        for i in range(10):
            store.write(i, rng.standard_normal((int(rng.integers(5, 9)), FEAT_DIM),
                                               dtype=np.float32))


def setup(root):
    """(dataset, caption-head config, feature store) of the corpus."""
    from on_device_image_captioning_torch.data.features_io import FeatureStore

    ds = load_coco_karpathy(str(root / "ann.json"))
    v = ds.vocab
    cfg = pcfg.CaptionerConfig(
        d_model=32, N_enc=1, N_dec=1, ff=64, num_heads=4, num_exp_enc_list=(4,),
        num_exp_dec=4, vocab_size=len(v), max_seq_len=12, img_feature_dim=FEAT_DIM,
        sos_idx=v.sos_idx, eos_idx=v.eos_idx, pad_idx=v.pad_idx, unk_idx=v.unk_idx)
    return ds, cfg, FeatureStore(str(root / "f.hdf5"))


def model(cfg):
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
    from on_device_image_captioning_torch.models.end_to_end import init_weights

    return init_weights(ExpansionNetV2(cfg), torch.Generator().manual_seed(SEED))


def shard(ds, rank, num_procs, mode):
    """The first loader batch of `rank` (a global batch of 4)."""
    return ShardedCaptionLoader(ds, [SEED], batch_size=4, rank=rank, num_procs=num_procs,
                                mode=mode).get_next_batch(12)


def tensors(ds, store, batch):
    """A loader batch as the step's tensors (the CLI's `materialize`)."""
    records = ds.records("train")
    feats, pads = store.read_batch([records[i]["img_id"] for i in batch["img_idxs"]])
    out = {"enc_input": torch.from_numpy(np.asarray(feats)),
           "enc_num_pads": torch.tensor(pads, dtype=torch.int32)}
    if "captions" in batch:
        out["captions"] = torch.tensor(batch["captions"], dtype=torch.long)
    return out


def noise(cfg, rows):
    """The sampler's Gumbel noise for `rows` of the whole batch's 4 x N rows."""
    g = torch.Generator().manual_seed(SEED + 1)
    whole = [-torch.log(-torch.log(torch.rand(4 * N_SAMPLES, cfg.vocab_size, generator=g)
                                   .clamp_min(1e-30))) for _ in range(SCST_LEN)]
    return [n[rows] for n in whole]


def scst_rows(ds, rank, num_procs):
    """(image indices, rows of the whole batch's noise) of a rank's SCST
    shard; the whole batch is rank 0's images, then rank 1's."""
    ids = shard(ds, rank, num_procs, "image_wise")["img_idxs"]
    first = sum(len(shard(ds, r, num_procs, "image_wise")["img_idxs"]) for r in range(rank))
    return ids, list(range(first * N_SAMPLES, (first + len(ids)) * N_SAMPLES))


def steps(net, cfg, ds, store, xe_batch, scst_ids, scst_noise):
    """The XE step, then the device-reward SCST step, on `net` (a model or a
    DataParallel): [(metrics, weights after the step)] of both."""
    from on_device_image_captioning_torch.parallel.mesh import replicated
    from on_device_image_captioning_torch.train.device_cider import DeviceCiderCorpus
    from on_device_image_captioning_torch.train.radam import PlainRAdam
    from on_device_image_captioning_torch.train.train_step import (
        make_scst_fused_step,
        make_xe_step,
    )

    bare = replicated(net).module
    opt = PlainRAdam(bare.parameters(), LR)  # its first steps scale with the gradient
    out = []
    metrics = make_xe_step(net, cfg, opt)(xe_batch)
    out.append(({"loss": float(metrics["loss"])}, {k: v.clone() for k, v in
                                                    bare.state_dict().items()}))
    corpus = DeviceCiderCorpus([r["captions"] for r in ds.records("train")], ds.vocab)
    step = make_scst_fused_step(net, cfg, opt, N_SAMPLES, SCST_LEN, cfg.sos_idx, cfg.eos_idx,
                                corpus.make_reward_fn("cpu"))
    feats = tensors(ds, store, {"img_idxs": scst_ids})
    metrics = step(feats, corpus.batch(scst_ids), noise=scst_noise)
    out.append(({k: float(metrics[k]) for k in ("loss", "reward", "baseline", "logprob_sum")},
                {k: v.clone() for k, v in bare.state_dict().items()}))
    return out


def main(rank, port, root):
    from on_device_image_captioning_torch.cli import train as cli
    from on_device_image_captioning_torch.parallel import mesh as pm

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    device = pm.init_distributed(torch.device("cpu"))
    assert pm.process_count() == 2 and pm.process_index() == rank
    ds, cfg, store = setup(root)
    xe_batch = tensors(ds, store, shard(ds, rank, 2, "caption_wise"))
    ids, rows = scst_rows(ds, rank, 2)
    out = steps(pm.DataParallel(model(cfg), device), cfg, ds, store, xe_batch, ids,
                noise(cfg, rows))
    torch.save({"steps": out, "xe_captions": xe_batch["captions"]}, root / f"rank{rank}.pt")
    store.close()
    pm.barrier()
    assert cli.main(["--annotations", str(root / "ann.json"), "--features_path",
                     str(root / "f.hdf5"), "--save_path", str(root / "cli_saves") + "/",
                     "--metrics_jsonl", str(root / "cli.jsonl"), "--distributed",
                     *CLI_FLAGS]) == 0
    print(f"WORKER {rank} done", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
