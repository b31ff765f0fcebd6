"""The port's `utils/checkpointing.py` and the optimizer state a checkpoint
carries: the JAX package's round-trip and rotation test
(tests/test_checkpointing.py) on the port; the file name across the two
packages; and resume bit for bit on the CPU: N straight XE steps equal k
steps, a save, a load into fresh objects and N - k steps, for RAdam,
PlainRAdam and Adam, each with and without gradient accumulation over 2
(RAdam's `count` and the accumulator's micro-step and summed gradients
travel in `state_dict`)."""
import dataclasses
import os
import time
from datetime import datetime

import numpy as np
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.models.end_to_end import init_weights
from on_device_image_captioning_torch.train import schedules
from on_device_image_captioning_torch.train.radam import PlainRAdam, RAdam
from on_device_image_captioning_torch.train.train_step import make_xe_step, with_grad_accum
from on_device_image_captioning_torch.utils import checkpointing as ckpt
from on_device_image_captioning_tpu.utils import checkpointing as jckpt

TINY = pcfg.CaptionerConfig(
    d_model=16, N_enc=3, N_dec=3, ff=32, num_heads=2, num_exp_enc_list=(2, 4),
    num_exp_dec=2, vocab_size=20, max_seq_len=10, img_feature_dim=8,
    sos_idx=2, eos_idx=3, pad_idx=0, unk_idx=1,
)


# the resume tests' model: one layer each side
SMALL = dataclasses.replace(TINY, N_enc=1, N_dec=1, num_exp_enc_list=(2,))


def model(seed=0, cfg=TINY):
    return init_weights(ExpansionNetV2(cfg), torch.Generator().manual_seed(seed))


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    m = model()
    opt = schedules.adam(m.parameters(), lambda k: 1e-3)
    m(torch.ones(2, 5, 8), torch.tensor([[2, 5, 6], [2, 7, 0]]), train=True).sum().backward()
    opt.step()
    loader_state = {"batch_it": 7, "epoch_it": 1, "batch_size": 4, "array_of_init_seed": [1, 2]}
    paths = []
    for i in range(4):
        paths.append(ckpt.save_checkpoint(
            str(tmp_path), m.state_dict(), opt.state_dict(), step=i,
            data_loader_state=loader_state, additional_info="xe", num_max_checkpoints=3,
            epoch_it=1, batch_it=7, batch_size=4))
    files = [f for f in os.listdir(tmp_path) if f.startswith("checkpoint_")]
    assert len(files) == 3  # rotation keeps the newest 3
    assert not os.path.exists(paths[0])

    payload, info = ckpt.load_most_recent(str(tmp_path))
    assert info == "xe"
    assert payload["step"] == 3
    assert payload["data_loader_state"] == loader_state
    assert payload["params"].keys() == m.state_dict().keys()
    for k, v in m.state_dict().items():
        torch.testing.assert_close(payload["params"][k], v, rtol=0, atol=0)
    fresh = schedules.adam(model(1).parameters(), lambda k: 1e-3)
    fresh.load_state_dict(payload["opt_state"])
    assert fresh.count == 1
    assert ckpt.load_most_recent(str(tmp_path / "none")) == (None, "no_additional_info")


def test_checkpoint_names_across_packages(tmp_path):
    """A name the port writes parses under the JAX package's `_NAME` and
    `_FMT` (and the other way round), and the newest by its stamp is the one
    either package loads."""
    port = os.path.basename(ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(2)},
                                                 additional_info="rf", epoch_it=2,
                                                 batch_it=5, batch_size=8))
    m = jckpt._NAME.match(port)
    assert m and m.group("info") == "rf" and port.endswith("_epoch2it5bs8_rf_")
    datetime.strptime(m.group("ts"), jckpt._FMT)
    time.sleep(0.01)
    jax = os.path.basename(jckpt.save_checkpoint(str(tmp_path / "j"), {"w": np.ones(2)},
                                                 additional_info="xe"))
    m = ckpt._NAME.match(jax)
    assert m and m.group("info") == "xe"
    assert datetime.strptime(m.group("ts"), ckpt._FMT) > datetime.strptime(
        ckpt._NAME.match(port).group("ts"), ckpt._FMT)
    assert not ckpt._NAME.match(port + ".tmp")


def batches(n, seed=0):
    """n seeded features-in batches of 3 rows with encoder and caption pads."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        caps = rng.integers(4, TINY.vocab_size, (3, 7))
        caps[:, 0] = TINY.sos_idx
        for row, length in enumerate(rng.integers(3, 8, 3)):
            caps[row, length - 1] = TINY.eos_idx
            caps[row, length:] = TINY.pad_idx
        out.append({"enc_input": torch.from_numpy(rng.standard_normal((3, 6, 8)).astype(np.float32)),
                    "enc_num_pads": torch.tensor(rng.integers(0, 3, 3), dtype=torch.int32),
                    "captions": torch.from_numpy(caps)})
    return out


OPTIMIZERS = {
    # the CLI's RAdam (b2 0.98: rectified from its sixth step on), PlainRAdam
    # (the SGD fallback before that), and Adam over a schedule
    "radam": lambda p: RAdam(p, lambda k: 1e-2 / (k + 1), b1=0.9, b2=0.98, eps=1e-9),
    "plain_radam": lambda p: PlainRAdam(p, 1e-2),
    "adam": lambda p: schedules.adam(p, lambda k: 1e-2 / (k + 1)),
}


@pytest.mark.parametrize("num_accum", [1, 2])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_is_bit_equal(tmp_path, name, num_accum):
    # 7 updates (RAdam rectifies its sixth and seventh); k mid-accumulation
    n, k = 7 * num_accum, 3 * num_accum - 1
    data = batches(n)

    def fresh():
        m = model(cfg=SMALL)
        opt = with_grad_accum(OPTIMIZERS[name](m.parameters()), num_accum)
        return m, opt, make_xe_step(m, SMALL, opt)

    m, _, step = fresh()
    straight = [float(step(b)["loss"]) for b in data]

    m1, opt1, step1 = fresh()
    resumed = [float(step1(b)["loss"]) for b in data[:k]]
    path = ckpt.save_checkpoint(str(tmp_path), m1.state_dict(), opt1.state_dict(), step=k)
    payload = ckpt.load_checkpoint(path)
    m2, opt2, step2 = fresh()
    m2.load_state_dict(payload["params"])
    opt2.load_state_dict(payload["opt_state"])
    if num_accum > 1:
        assert opt2.micro == k % num_accum == 1
    inner = opt2.optimizer if num_accum > 1 else opt2
    assert inner.count == k // num_accum
    resumed += [float(step2(b)["loss"]) for b in data[k:]]
    assert resumed == straight
    for (key, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=key)

    # the saved optimizer state is what makes it exact: weights alone differ
    m3, _, step3 = fresh()
    m3.load_state_dict(payload["params"])
    for b in data[k:]:
        step3(b)
    assert any(not torch.equal(a, b) for a, b in zip(m.parameters(), m3.parameters()))
