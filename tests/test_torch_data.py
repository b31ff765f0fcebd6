"""The port's data layer against the JAX package's: the vocabulary and caption
helpers of `data/text.py`, both dataset loaders (records, vocabulary,
`max_seq_len`) on a Karpathy and a VizWiz file the test writes, feature and
image stores written by each package and read by the other, and
`PrefetchIterator` (order, error propagation, shutdown, the consumed cursor;
mirroring tests/test_prefetch.py)."""
import json
import time

import numpy as np
import pytest

from on_device_image_captioning_torch.data import datasets as pds
from on_device_image_captioning_torch.data import features_io as pfio
from on_device_image_captioning_torch.data import images_io as pimg
from on_device_image_captioning_torch.data import text as ptext
from on_device_image_captioning_torch.data.prefetch import PrefetchIterator
from on_device_image_captioning_tpu.data import datasets as jds
from on_device_image_captioning_tpu.data import features_io as jfio
from on_device_image_captioning_tpu.data import images_io as jimg
from on_device_image_captioning_tpu.data import text as jtext

WORDS = "a the cat dog man rides holds red ball bike sits on near street Park".split()


def raw_captions(rng, n, lo=3, hi=14):
    """Raw captions with case, punctuation and clitics for the cleaning rules."""
    extra = ["dog's", "isn't", ",", ".", "!", "--", "(big)", "1,000"]
    return [" ".join(rng.choice(WORDS + extra, size=int(rng.integers(lo, hi)))) for _ in range(n)]


def vocab_fields(v):
    return v.word2idx, v.idx2word, (v.pad_idx, v.sos_idx, v.eos_idx, v.unk_idx)


@pytest.mark.parametrize("min_occurrences", [1, 3, 5])
def test_text_helpers_match_jax(tmp_path, min_occurrences):
    rng = np.random.default_rng(min_occurrences)
    caps = raw_captions(rng, 40)
    pv = ptext.Vocab.build(caps, min_occurrences)
    jv = jtext.Vocab.build(caps, min_occurrences)
    assert vocab_fields(pv) == vocab_fields(jv)
    for c in caps + ["an unseen zebra, on ice."]:
        assert ptext.clean_caption(c) == jtext.clean_caption(c)
        assert ptext.tokenize(c) == jtext.tokenize(c)
        assert pv.encode(ptext.tokenize(c)) == jv.encode(jtext.tokenize(c))
        ids = pv.encode_caption(c)
        assert ids == jv.encode_caption(c)
        assert pv.decode(ids) == jv.decode(ids)
        assert pv.description(ids) == jv.description(ids)
    seqs = [pv.encode_caption(c) for c in caps[:7]]
    assert ptext.pad_batch(seqs, pv.pad_idx) == jtext.pad_batch(seqs, jv.pad_idx)
    assert ptext.compute_num_pads(seqs) == jtext.compute_num_pads(seqs)
    path = str(tmp_path / "vocab.json")
    pv.to_json(path)
    assert vocab_fields(jtext.Vocab.from_json(path)) == vocab_fields(pv)
    assert vocab_fields(ptext.Vocab.from_json(path)) == vocab_fields(pv)


def records_equal(a, b):
    assert a.splits == b.splits
    assert vocab_fields(a.vocab) == vocab_fields(b.vocab)
    assert a.max_seq_len == b.max_seq_len and a.image_root == b.image_root


@pytest.mark.parametrize("case", ["built", "given_vocab", "limited"])
def test_coco_karpathy_matches_jax(tmp_path, case):
    rng = np.random.default_rng(3)
    splits = ["train", "restval", "val", "test"]
    items = [{
        "cocoid": 100 + i, "filepath": "val2014" if i % 2 else "train2014",
        "filename": f"img{i}.jpg", "split": splits[i % 4],
        "sentences": [{"raw": c} for c in raw_captions(rng, 5)],
    } for i in range(24)]
    ann = tmp_path / "dataset_coco.json"
    ann.write_text(json.dumps({"images": items}))
    kw = {"images_path": "/data", "dict_min_occurrences": 2}
    if case == "given_vocab":
        kw["vocab"] = ptext.Vocab.build(raw_captions(rng, 30), 1)
    if case == "limited":
        kw["limited"] = {"train": 5, "test": 2}
    got = pds.load_coco_karpathy(str(ann), **kw)
    if case == "given_vocab":
        kw["vocab"] = jtext.Vocab(dict(kw["vocab"].word2idx))
    want = jds.load_coco_karpathy(str(ann), **kw)
    records_equal(got, want)
    assert got.num_images("train") == want.num_images("train") > 0


@pytest.mark.parametrize("strict, include_test", [(True, False), (False, True)])
def test_vizwiz_matches_jax(tmp_path, strict, include_test):
    rng = np.random.default_rng(4)
    for split in ("train", "val", "test"):
        images = [{"id": i, "file_name": f"{split}_{i}.jpg"} for i in range(8)]
        anns = [{"image_id": i, "caption": c} for i in range(8)
                for c in raw_captions(rng, 3, 4, 30)]
        anns += [{"image_id": i, "caption": jds.QUALITY_SENTINEL} for i in (1, 4)]
        anns += [{"image_id": 6, "caption": jds.QUALITY_SENTINEL}] * 2
        (tmp_path / f"{split}.json").write_text(json.dumps({"images": images,
                                                            "annotations": anns}))
    kw = dict(images_dir="/viz", dict_min_occurrences=2, max_seq_len=20,
              include_test=include_test, strict_filter=strict)
    got, want = pds.load_vizwiz(str(tmp_path), **kw), jds.load_vizwiz(str(tmp_path), **kw)
    records_equal(got, want)
    for r in got.records("train"):
        for c in r["captions"]:
            for n in (5, 12, 20):
                assert pds.encode_caption_truncated(got.vocab, c, n) == \
                    jds.encode_caption_truncated(want.vocab, c, n)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_feature_store_across_packages(tmp_path, writer):
    """A store written by one package reads the same in the other, float32
    and float16 entries, batches padded on the token dimension."""
    path = str(tmp_path / "features.hdf5")
    rng = np.random.default_rng(0)
    feats = {11: rng.standard_normal((12, 16), dtype=np.float32),
             22: rng.standard_normal((9, 16), dtype=np.float32).astype(np.float16),
             33: rng.standard_normal((10, 16), dtype=np.float32)}
    w, r = (pfio, jfio) if writer == "port" else (jfio, pfio)
    with w.FeatureStore(path, "w") as store:
        for k, f in feats.items():
            store.write(k, f)
    with r.FeatureStore(path) as got, w.FeatureStore(path) as want:
        assert 11 in got and 44 not in got
        for k in feats:
            np.testing.assert_array_equal(got.read(k), want.read(k))
            assert got.read(k).dtype == np.float32
        for pad_to in (None, 14):
            a, b = got.read_batch([11, 22, 33], pad_to), want.read_batch([11, 22, 33], pad_to)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_image_store_across_packages(tmp_path, writer):
    """`build_store` of one package (JPEG decode and resize on the host), read
    through the other's `PreprocessedImageStore`."""
    from PIL import Image

    rng = np.random.default_rng(1)
    records = []
    for i in range(3):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (17, 23, 3), dtype=np.uint8)).save(p)
        records.append({"img_id": 100 + i, "img_path": str(p)})
    w, r = (pimg, jimg) if writer == "port" else (jimg, pimg)
    path = str(tmp_path / "preproc.hdf5")
    w.build_store(path, records, size=16, verbose=False)
    other = str(tmp_path / "other.hdf5")
    r.build_store(other, records, size=16, verbose=False)
    with r.PreprocessedImageStore(path) as got, w.PreprocessedImageStore(other) as want:
        assert 100 in got and 999 not in got
        batch = got.read_batch([100, 101, 102])
        assert batch.shape == (3, 16, 16, 3) and batch.dtype == np.uint8
        np.testing.assert_array_equal(batch, want.read_batch([100, 101, 102]))


# -- PrefetchIterator (tests/test_prefetch.py on the port's copy) -------------


def test_prefetch_preserves_order():
    n = [0]

    def next_batch():
        n[0] += 1
        return {"i": n[0]}

    pf = PrefetchIterator(next_batch, lambda b: {"x": b["i"] * 10}, depth=3)
    got = [pf.get() for _ in range(10)]
    pf.close()
    assert [b["i"] for b, _ in got] == list(range(1, 11))
    assert [a["x"] for _, a in got] == [i * 10 for i in range(1, 11)]


def test_prefetch_propagates_errors():
    def bad_batch():
        raise RuntimeError("loader broke")

    pf = PrefetchIterator(bad_batch, lambda b: b, depth=1)
    with pytest.raises(RuntimeError, match="loader broke"):
        pf.get()
    pf.close()


def test_prefetch_drains_queue_before_raising():
    it = iter(range(5))
    pf = PrefetchIterator(lambda: next(it), lambda b: b, depth=4)
    time.sleep(0.3)
    got = []
    with pytest.raises(StopIteration):
        while True:
            b, _ = pf.get()
            got.append(b)
    pf.close()
    assert got == [0, 1, 2, 3, 4]


def test_prefetch_close_stops_a_blocked_worker():
    """close() on an endless producer whose queue is full returns and leaves
    the worker thread stopped."""
    pf = PrefetchIterator(lambda: {}, lambda b: b, depth=1)
    time.sleep(0.1)  # the worker fills the queue and blocks on it
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_consumed_state_tracks_consumption():
    class FakeLoader:
        def __init__(self):
            self.i = 0

        def next(self):
            b = {"i": self.i}
            self.i += 1
            return b

        def save_state(self):
            return {"next": self.i}

    ld = FakeLoader()
    pf = PrefetchIterator(ld.next, lambda b: b, depth=3, snapshot=ld.save_state)
    assert pf.consumed_state == {"next": 0}
    for k in range(6):
        b, _ = pf.get()
        assert b["i"] == k
        assert pf.consumed_state == {"next": k + 1}
    pf.close()
