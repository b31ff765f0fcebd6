"""The port's `data/loader.py` (a copy) against the JAX package's: over
several seeds, both modes and 1, 2 and 4 ranks, the same schedule, the same
materialized batches (`img_idxs`, `captions`, `num_pads`, `all_captions`),
the same `save_state` / `load_state` round trip and the same epoch
rollover; and the JAX package's three loader tests (tests/test_data.py) on
the port."""
import numpy as np
import pytest

from on_device_image_captioning_torch.data import text as ptext
from on_device_image_captioning_torch.data.datasets import CaptionDataset as PortDataset
from on_device_image_captioning_torch.data.loader import ShardedCaptionLoader
from on_device_image_captioning_tpu.data import text as jtext
from on_device_image_captioning_tpu.data.datasets import CaptionDataset as JaxDataset
from on_device_image_captioning_tpu.data.loader import ShardedCaptionLoader as JaxLoader

WORDS = ["cat", "dog", "ball", "red", "runs", "jumps", "big", "small"]


def records(n_images=40, seed=0, lo=2, hi=9):
    """Captions of lo..hi words, 1 to 4 an image: batches carry pads."""
    rng = np.random.default_rng(seed)
    return [{"img_id": 1000 + i, "img_path": f"/img/{i}.jpg",
             "captions": [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))
                          for _ in range(int(rng.integers(1, 5)))]} for i in range(n_images)]


def datasets(recs, max_seq_len=20):
    caps = [c for r in recs for c in r["captions"]]
    splits = {"train": recs, "val": recs[:2], "test": recs[:2]}
    return (PortDataset(splits=splits, vocab=ptext.Vocab.build(caps, 1), max_seq_len=max_seq_len),
            JaxDataset(splits=splits, vocab=jtext.Vocab.build(caps, 1), max_seq_len=max_seq_len))


def _toy_dataset(n_images=12, caps_per_image=3):
    rng = np.random.default_rng(0)
    recs, corpus = [], []
    for i in range(n_images):
        caps = [" ".join(rng.choice(WORDS, size=4)) for _ in range(caps_per_image)]
        corpus += caps
        recs.append({"img_id": 1000 + i, "img_path": f"/img/{i}.jpg", "captions": caps})
    return PortDataset(splits={"train": recs, "val": recs[:2], "test": recs[:2]},
                       vocab=ptext.Vocab.build(corpus, min_occurrences=1), max_seq_len=20)


@pytest.mark.parametrize("mode", ["caption_wise", "image_wise"])
@pytest.mark.parametrize("num_procs", [1, 2, 4])
def test_loader_matches_jax(mode, num_procs):
    """Every rank's batches over three epochs (two rollovers) equal the JAX
    loader's, field for field, for three seed lists; a cursor saved mid-epoch
    and loaded into a fresh loader of the other package continues alike."""
    for seed in (0, 1, 2):
        port_ds, jax_ds = datasets(records(seed=seed))
        seeds = [seed + 10 * e for e in range(3)]
        for rank in range(num_procs):
            mk = dict(batch_size=4, rank=rank, num_procs=num_procs, mode=mode)
            p, j = ShardedCaptionLoader(port_ds, seeds, **mk), JaxLoader(jax_ds, seeds, **mk)
            assert p.get_num_batches() == j.get_num_batches() > 0
            assert p._schedule == j._schedule
            for _ in range(3 * p.get_num_batches() + 1):
                a, b = p.get_next_batch(12), j.get_next_batch(12)
                assert a == b
                assert p.get_epoch_it() == j.get_epoch_it()
                assert p.save_state() == j.save_state()
            assert p.get_epoch_it() == 3
            for _ in range(p.get_num_batches() // 2):
                p.get_next_batch()
                j.get_next_batch()
            state = p.save_state()
            assert state == j.save_state()
            other = dict(batch_size=2, rank=rank, num_procs=num_procs, mode=mode)
            fresh_p = ShardedCaptionLoader(port_ds, [99], **other)
            fresh_j = JaxLoader(jax_ds, [99], **other)
            fresh_p.load_state(j.save_state())
            fresh_j.load_state(state)
            for _ in range(3):
                want = p.get_next_batch()
                assert fresh_p.get_next_batch() == want == fresh_j.get_next_batch()


def test_sharded_loader_disjoint_deterministic():
    ds = _toy_dataset()
    mk = lambda rank: ShardedCaptionLoader(ds, [42], batch_size=4, rank=rank,  # noqa: E731
                                           num_procs=2)
    l0a, l0b, l1 = mk(0), mk(0), mk(1)
    seen0, seen0b, seen1 = [], [], []
    for _ in range(l0a.get_num_batches()):
        seen0 += [tuple(x) for x in zip(l0a.get_next_batch()["img_idxs"])]
        seen0b += [tuple(x) for x in zip(l0b.get_next_batch()["img_idxs"])]
        seen1 += [tuple(x) for x in zip(l1.get_next_batch()["img_idxs"])]
    assert seen0 == seen0b  # deterministic
    assert l0a.get_num_batches() == l1.get_num_batches()
    assert len(l0a._schedule[0]) == 2  # per-rank batch is global / num_procs


def test_loader_cursor_roundtrip():
    ds = _toy_dataset()
    loader = ShardedCaptionLoader(ds, [1, 2], batch_size=4)
    for _ in range(3):
        loader.get_next_batch()
    state = loader.save_state()
    fresh = ShardedCaptionLoader(ds, [9], batch_size=2)
    fresh.load_state(state)
    a = fresh.get_next_batch()
    b = loader.get_next_batch()
    assert a["img_idxs"] == b["img_idxs"]
    assert a["captions"] == b["captions"]


def test_loader_epoch_rollover_and_modes():
    ds = _toy_dataset()
    loader = ShardedCaptionLoader(ds, [7, 8], batch_size=6)
    n = loader.get_num_batches()
    for _ in range(n):
        batch = loader.get_next_batch()
        assert len(batch["captions"]) == 6
        assert all(c[0] == ds.vocab.sos_idx for c in batch["captions"])
    assert loader.get_epoch_it() == 0
    loader.get_next_batch()
    assert loader.get_epoch_it() == 1

    img_loader = ShardedCaptionLoader(ds, [7], batch_size=4, mode="image_wise")
    batch = img_loader.get_next_batch()
    assert len(batch["img_idxs"]) == 4
    assert len(batch["all_captions"][0]) == 3  # all refs for SCST
