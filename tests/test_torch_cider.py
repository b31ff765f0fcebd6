"""The port's SCST reward path against the JAX package on the CPU: caption
cleaning, the CIDEr-D scorer (Python and native C++), the host reward
`CiderReward`, and the on-card CIDEr-D (`train/device_cider.py`: its numpy
tables bit for bit, its tensor scorer against the JAX scorer and the
host reward).

Corpora and captions come from numpy with a seed. Tolerances: the host
scorers are float64 arithmetic on both sides (the native one float32 at the
end), rtol 1e-6; the device scorer is float32 tensor code in another
framework's summation order, 1e-4 on the fuzz and 1e-5 on the hand-made
cases, as the JAX package's own `tests/test_device_cider.py` holds its scorer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.data import text as ptext
from on_device_image_captioning_torch.evalcap import cider as pcider
from on_device_image_captioning_torch.evalcap import cider_native as pnative
from on_device_image_captioning_torch.train import device_cider as pdev
from on_device_image_captioning_torch.train import scst as pscst
from on_device_image_captioning_tpu.data import text as jtext
from on_device_image_captioning_tpu.evalcap import cider as jcider
from on_device_image_captioning_tpu.evalcap import cider_native as jnative
from on_device_image_captioning_tpu.train import device_cider as jdev
from on_device_image_captioning_tpu.train import scst as jscst

AWKWARD = [
    "A man riding a wave on top of a surfboard.",
    "  Two dogs -- playing,   in the SNOW!!  ",
    "it's a cat's toy; isn't it?",
    "The 3rd-place runner... at 10:30 a.m.",
    "``quoted'' words and `ticks`",
    "émigré café — naïve façade",
    "tabs\tand\nnew lines\r\n",
    "",
    "...",
    "under_score and dash-es and slash/es",
    "UPPER lower MiXeD 123abc",
    "$5 & 50% off #sale @store",
]


@pytest.mark.parametrize("text", AWKWARD)
def test_clean_caption_and_tokenize_match_jax(text):
    assert ptext.clean_caption(text) == jtext.clean_caption(text)
    assert ptext.tokenize(text) == jtext.tokenize(text)


def _vocab(mod, n_words=40):
    words = [mod.PAD_TOKEN, mod.SOS_TOKEN, mod.EOS_TOKEN, mod.UNK_TOKEN] + [
        f"w{i}" for i in range(n_words)]
    return mod.Vocab({w: i for i, w in enumerate(words)})


def _random_refs(rng, n_images, n_words=40, r_lo=2, r_hi=5, max_len=12):
    words = [f"w{i}" for i in range(n_words)]
    return [[" ".join(rng.choice(words, size=int(rng.integers(1, max_len)), replace=True))
             for _ in range(int(rng.integers(r_lo, r_hi + 1)))]
            for _ in range(n_images)]


def _random_hyps(rng, n, n_words=40, max_len=14):
    words = [f"w{i}" for i in range(n_words)]
    return [" ".join(rng.choice(words, size=int(rng.integers(1, max_len)), replace=True))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cider_corpus_matches_jax(seed):
    rng = np.random.default_rng(seed)
    refs = _random_refs(rng, 12, n_words=15)
    hyps = _random_hyps(rng, 20, n_words=15)
    idx = rng.integers(0, len(refs), len(hyps))
    got = pcider.CiderCorpus(refs).score_hypotheses(hyps, idx)
    want = jcider.CiderCorpus(refs).score_hypotheses(hyps, idx)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(np.abs(want).max()) > 0  # some n-grams matched
    gts = {i: refs[i] for i in range(len(refs))}
    res = {i: [hyps[i]] for i in range(len(refs))}
    g_mean, g_scores = pcider.compute_cider(gts, res)
    w_mean, w_scores = jcider.compute_cider(gts, res)
    np.testing.assert_allclose(g_scores, w_scores, rtol=1e-6)
    np.testing.assert_allclose(g_mean, w_mean, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_cider_matches_jax_and_python(seed):
    assert pnative.NativeCiderCorpus.available()
    rng = np.random.default_rng(10 + seed)
    refs = _random_refs(rng, 10, n_words=12)
    hyps = _random_hyps(rng, 16, n_words=12)
    idx = rng.integers(0, len(refs), len(hyps))
    got = pnative.NativeCiderCorpus(refs).score_hypotheses(hyps, idx)
    assert got.dtype == np.float32
    want = jnative.NativeCiderCorpus(refs).score_hypotheses(hyps, idx)
    np.testing.assert_array_equal(got, want)  # the same C++ source
    np.testing.assert_allclose(got, pcider.CiderCorpus(refs).score_hypotheses(hyps, idx),
                               rtol=1e-6, atol=1e-6)


def _sampled(vocab, captions, L):
    """captions: per image, per sample, a word list -> (B, S, L+1) tokens
    (SOS, the words, EOS, PAD after) and the lengths (index of the EOS)."""
    b, s = len(captions), len(captions[0])
    toks = np.full((b, s, L + 1), vocab.pad_idx, np.int32)
    lens = np.zeros((b, s), np.int32)
    toks[:, :, 0] = vocab.sos_idx
    for i, rows in enumerate(captions):
        for j, words in enumerate(rows):
            ids = [vocab.word2idx[w] for w in words] + [vocab.eos_idx]
            toks[i, j, 1:1 + len(ids)] = ids
            lens[i, j] = len(ids)
    return toks, lens


@pytest.mark.parametrize("use_native", ["never", "always", "auto"])
def test_cider_reward_matches_jax(use_native):
    rng = np.random.default_rng(3)
    pv, jv = _vocab(ptext, 20), _vocab(jtext, 20)
    refs = _random_refs(rng, 8, n_words=20)
    refs[0][0] = "A W1, w2 -- W3!"  # cleaned before scoring
    words = [f"w{i}" for i in range(20)]
    captions = [[list(rng.choice(words, size=int(rng.integers(0, 9)))) for _ in range(3)]
                for _ in range(4)]
    toks, lens = _sampled(pv, captions, 10)
    idx = np.array([0, 3, 5, 7])
    reward = pscst.CiderReward(refs, use_native=use_native)
    native = isinstance(reward.corpus, pnative.NativeCiderCorpus)
    assert native == (use_native != "never")
    got = reward(toks, lens, idx, pv)
    want = jscst.CiderReward(refs, use_native=use_native)(toks, lens, idx, jv)
    assert got.shape == (4, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # tensors are read on the host
    np.testing.assert_array_equal(reward(torch.from_numpy(toks), torch.from_numpy(lens), idx, pv),
                                  got)


@pytest.mark.parametrize("seed, max_refs", [(0, None), (1, 2), (2, None)])
def test_device_cider_tables_equal_jax(seed, max_refs):
    """The numpy table code is the JAX package's: every table and probe depth
    bit for bit, OOV references included."""
    rng = np.random.default_rng(seed)
    refs = _random_refs(rng, 25, n_words=50)
    refs[1].append("w0 zebra w1 quagga")  # out-of-vocabulary reference words
    got = pdev.DeviceCiderCorpus(refs, _vocab(ptext, 40), max_refs=max_refs)
    want = jdev.DeviceCiderCorpus(refs, _vocab(jtext, 40), max_refs=max_refs)
    for name in ("ref_lo", "ref_hi", "ref_tf", "ref_norm", "ref_blen", "ref_valid"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.log_ref_len == want.log_ref_len
    assert got.probe_depths == want.probe_depths
    assert len(got.tables) == len(want.tables) == pdev.N
    for a, b in zip(got.tables, want.tables):
        assert a["size"] == b["size"] and a["probes"] == b["probes"]
        for key in ("lo", "hi", "idf"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    idx = rng.integers(0, len(refs), 5)
    for key, value in got.batch(idx).items():
        assert np.array_equal(value, want.batch(idx)[key]), key
    tables = got.device_tables("cpu")
    assert all(t.device.type == "cpu" for t in tables.values())
    assert np.array_equal(tables["df2_lo"].numpy(), want.tables[2]["lo"])


def test_device_hash_bit_agrees_with_the_host_insert():
    """The tensor hash (int64 masked to 32 bits) equals the host insert's uint32
    hash for every key in the tables and for random keys over the whole
    packed range, and every key in a table is found by the probe."""
    rng = np.random.default_rng(4)
    corpus = pdev.DeviceCiderCorpus(_random_refs(rng, 30, n_words=40), _vocab(ptext, 40))
    for k, t in enumerate(corpus.tables):
        keys_lo = np.concatenate([t["lo"][t["lo"] != -1],
                                  rng.integers(0, 2**30, 500).astype(np.int32)])
        keys_hi = np.concatenate([t["hi"][t["lo"] != -1],
                                  rng.integers(0, 2**30, 500).astype(np.int32)])
        with np.errstate(over="ignore"):
            want = ((keys_lo.astype(np.uint32) * pdev._H1)
                    ^ (keys_hi.astype(np.uint32) * pdev._H2)).astype(np.int64)
        lo, hi = torch.from_numpy(keys_lo).long(), torch.from_numpy(keys_hi).long()
        got = pdev._mul_u32(lo, int(pdev._H1)) ^ pdev._mul_u32(hi, int(pdev._H2))
        np.testing.assert_array_equal(got.numpy(), want)
        stored = t["lo"] != -1
        idf = pdev._df_lookup(torch.from_numpy(t["lo"][stored]), torch.from_numpy(t["hi"][stored]),
                              *(torch.from_numpy(t[key]) for key in ("lo", "hi", "idf")),
                              t["probes"], corpus.log_ref_len)
        np.testing.assert_array_equal(idf.numpy(), t["idf"][stored])


def _three_way(refs, captions, L, img_idx, tol, n_words=40):
    """The port's device scorer (on the CPU) against the JAX scorer and the
    host CiderReward on the same captions."""
    pv, jv = _vocab(ptext, n_words), _vocab(jtext, n_words)
    toks, lens = _sampled(pv, captions, L)
    dev = pdev.DeviceCiderCorpus(refs, pv)
    got = dev.make_reward_fn("cpu")(torch.from_numpy(toks), torch.from_numpy(lens),
                                    dev.batch(img_idx))
    assert got.shape == lens.shape and got.dtype == torch.float32
    jcorpus = jdev.DeviceCiderCorpus(refs, jv)
    bt = {k: jnp.asarray(v) for k, v in jcorpus.batch(img_idx).items()}
    want_jax = np.asarray(jax.jit(lambda t, l, b: jdev.cider_reward(
        t, l, b, jcorpus.device_tables(), jcorpus.probe_depths, jcorpus.log_ref_len))(
        jnp.asarray(toks), jnp.asarray(lens), bt))
    want_host = pscst.CiderReward(refs, use_native="never")(toks, lens, img_idx, pv)
    np.testing.assert_allclose(got.numpy(), want_jax, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), want_host, rtol=tol, atol=tol)
    return got.numpy()


def test_device_cider_matches_jax_and_host_fuzz():
    rng = np.random.default_rng(0)
    refs = _random_refs(rng, 30)
    b, s, L = 6, 3, 16
    words = [f"w{i}" for i in range(40)]
    captions = [[list(rng.choice(words, size=int(rng.integers(1, L - 1)), replace=True))
                 for _ in range(s)] for _ in range(b)]
    got = _three_way(refs, captions, L, rng.integers(0, len(refs), b), 1e-4)
    assert (got > 0).any()


def test_device_cider_exact_match_and_repeats():
    refs = [["w0 w1 w2 w3 w4", "w0 w0 w0 w1", "w2 w3"], ["w5 w6 w5 w6 w5", "w6 w5 w6"]]
    captions = [[["w0", "w1", "w2", "w3", "w4"], ["w0", "w0", "w0", "w0"]],
                [["w5", "w6", "w5", "w6", "w5"], ["w9"]]]
    _three_way(refs, captions, 8, np.array([0, 1]), 1e-5, n_words=10)


def test_device_cider_short_and_immediate_eos():
    refs = [["w0 w1", "w2"]]
    captions = [[["w0"], []]]  # one-word caption; empty caption (EOS only)
    _three_way(refs, captions, 6, np.array([0]), 1e-5, n_words=10)


def test_device_cider_oov_reference_words():
    """Reference words outside the model vocabulary get private extended ids:
    distinct OOV words must not alias each other or UNK."""
    refs = [["w0 zebra w1", "w0 quagga w1"], ["w2 zebra"]]
    captions = [[["w0", "w1"]], [["w2"]]]
    _three_way(refs, captions, 5, np.array([0, 1]), 1e-5, n_words=6)


def test_device_cider_idf_lookup_misses_yield_logn():
    """A sampled gram absent from the whole corpus weighs in at idf = log(N)
    (the host scorer's df=0 branch) through the hash-table miss path."""
    refs = [["w0 w1"], ["w2 w3"], ["w4 w5"], ["w6 w7"]]
    captions = [[["w8", "w9", "w8", "w9"]]]  # nothing from the corpus
    _three_way(refs, captions, 6, np.array([2]), 1e-5, n_words=10)
    corpus = pdev.DeviceCiderCorpus(refs, _vocab(ptext, 10))
    t = corpus.tables[0]
    miss = pdev._df_lookup(torch.tensor([9 | (9 << 15)]), torch.tensor([2**30 - 1]),
                           *(torch.from_numpy(t[key]) for key in ("lo", "hi", "idf")),
                           t["probes"], corpus.log_ref_len)
    assert float(miss) == np.float32(np.log(4.0))


def test_device_tables_default_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU: with
    no card the default placement raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    corpus = pdev.DeviceCiderCorpus([["w0 w1"]], _vocab(ptext, 4))
    with pytest.raises((AssertionError, RuntimeError)):
        corpus.make_reward_fn()
