"""Data parallelism of the port (`parallel/mesh.py`) in two processes on gloo
(mirroring tests/test_multihost.py and tests/_multihost_worker.py).

Each process (tests/_torch_ddp_worker.py) takes its loader shard of a global
batch of 4 whose captions carry other pad counts on each rank, and runs
through `DataParallel` an XE step and a device-reward SCST step; one process
runs the same steps on the whole batch. The XE loss of the whole batch is
its tokens' sum over ALL ranks' non-pad tokens: the mean of the ranks' own
normalized losses is not it (checked), and DDP's mean of their gradients is
the whole batch's only under the port's normalization. Both steps' losses
agree within 1e-5 relative, the weights after each (PlainRAdam, whose first
steps scale with the gradient) within 1e-6 absolute (fp32 sums in another
order), and the two ranks hold the same weights. Then both run
`cli/train.py --distributed` for an epoch: rank 0 alone writes the one
checkpoint, whose weights and logged losses match a one-process run of the
CLI on the same global batches (the updates are Adam's, 1e-3: within 1e-5
under tests/test_torch_train_cli.py's `assert_adam_close`).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ddp_worker as w
from on_device_image_captioning_torch.cli import train as cli
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.models.end_to_end import init_weights
from on_device_image_captioning_torch.train.train_step import xe_loss
from on_device_image_captioning_torch.utils import checkpointing as ckpt
from test_torch_train_cli import assert_adam_close


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_ddp_matches_one_process(tmp_path):
    w.write_corpus(tmp_path)
    port = _free_port()
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, w.__file__, str(rank), str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a DDP worker did not finish within 120 s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]

    # the one-process reference on the whole batch: rank 0's rows, then rank 1's
    ds, cfg, store = w.setup(tmp_path)
    caps = [r["xe_captions"] for r in ranks]
    width = max(c.shape[1] for c in caps)
    whole = {k: torch.cat([w.tensors(ds, store, w.shard(ds, r, 2, "caption_wise"))[k]
                           for r in (0, 1)]) for k in ("enc_input", "enc_num_pads")}
    whole["captions"] = torch.cat([torch.nn.functional.pad(c, (0, width - c.shape[1]),
                                                           value=cfg.pad_idx) for c in caps])
    tokens = [int((c[:, 1:] != cfg.pad_idx).sum()) for c in caps]
    assert tokens[0] != tokens[1], tokens  # the ranks' pad counts differ
    m = w.model(cfg)
    with torch.no_grad():
        per_rank = [float(xe_loss(m, cfg, w.tensors(ds, store, w.shard(ds, r, 2,
                                                                        "caption_wise"))))
                    for r in (0, 1)]
        assert abs(np.mean(per_rank) - float(xe_loss(m, cfg, whole))) > 1e-3
    ids = sum((w.scst_rows(ds, r, 2)[0] for r in (0, 1)), [])
    want = w.steps(m, cfg, ds, store, whole, ids, w.noise(cfg, list(range(4 * w.N_SAMPLES))))
    store.close()
    for i, (metrics, weights) in enumerate(want):
        for r in (0, 1):
            got_metrics, got_weights = ranks[r]["steps"][i]
            for k, v in metrics.items():
                assert got_metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-7), (i, r, k)
            for k, v in weights.items():
                torch.testing.assert_close(got_weights[k], v, rtol=0, atol=1e-6,
                                           msg=(i, r, k))
                torch.testing.assert_close(got_weights[k], ranks[0]["steps"][i][1][k],
                                           rtol=0, atol=0)

    # the CLI: one checkpoint, rank 0's, equal to one process's run
    files = [f for f in os.listdir(tmp_path / "cli_saves") if f.startswith("checkpoint_")]
    assert len(files) == 1, files
    args = ["--annotations", str(tmp_path / "ann.json"), "--features_path",
            str(tmp_path / "f.hdf5"), *w.CLI_FLAGS]
    assert cli.main([*args, "--save_path", str(tmp_path / "one") + "/",
                     "--metrics_jsonl", str(tmp_path / "one.jsonl")]) == 0
    ddp, _ = ckpt.load_most_recent(str(tmp_path / "cli_saves"))
    one, _ = ckpt.load_most_recent(str(tmp_path / "one"))
    assert ddp["step"] == one["step"] == 6
    logged = [[row["loss"] for row in map(json.loads, open(tmp_path / name))]
              for name in ("cli.jsonl", "one.jsonl")]
    np.testing.assert_allclose(logged[0], logged[1], rtol=1e-5)
    # both CLI runs start from the weights of the CLI's --seed 3
    init = init_weights(ExpansionNetV2(cfg), torch.Generator().manual_seed(3)).state_dict()
    assert_adam_close(ddp["params"], one["params"], init, 6, 1e-3)
