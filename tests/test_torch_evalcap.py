"""The port's caption metrics (`on_device_image_captioning_torch/evalcap/`)
against the JAX package's originals on a seeded synthetic corpus: the PTB
tokenizer, BLEU 1-4, ROUGE-L, native METEOR, native SPICE and the COCO
harness with every metric. Corpus scores and per-image scores must be equal
as floats. With no `*_JAR` variable set the harness picks the native METEOR
and SPICE scorers and warns once per metric; the jar wrappers refuse to start
without a jar, as the originals do.
"""
import warnings

import numpy as np
import pytest

from on_device_image_captioning_torch.evalcap import bleu as pbleu
from on_device_image_captioning_torch.evalcap import harness as pharness
from on_device_image_captioning_torch.evalcap import meteor as pmeteor
from on_device_image_captioning_torch.evalcap import meteor_native as pmn
from on_device_image_captioning_torch.evalcap import rouge as prouge
from on_device_image_captioning_torch.evalcap import spice as pspice
from on_device_image_captioning_torch.evalcap import spice_native as psn
from on_device_image_captioning_torch.evalcap import tokenizer as ptok
from on_device_image_captioning_tpu.evalcap import bleu as jbleu
from on_device_image_captioning_tpu.evalcap import harness as jharness
from on_device_image_captioning_tpu.evalcap import meteor as jmeteor
from on_device_image_captioning_tpu.evalcap import meteor_native as jmn
from on_device_image_captioning_tpu.evalcap import rouge as jrouge
from on_device_image_captioning_tpu.evalcap import spice as jspice
from on_device_image_captioning_tpu.evalcap import spice_native as jsn
from on_device_image_captioning_tpu.evalcap import tokenizer as jtok

JARS = ("METEOR_JAR", "SPICE_JAR", "CORENLP_JAR")
# caption words with synonyms, stems, clitics and punctuation, so that every
# matcher stage and tokenizer rule has work
WORDS = (
    "a the man men woman people person riding rides ride horse horses dog dogs "
    "puppy cat sits sitting on top of next to near a large big small little red "
    "blue white street road park grass field sky water table plate food pizza "
    "two three is are with holding holds bike bicycle car truck playing frisbee "
    "man's dog's doesn't can't it's they're , . ! ; ( ) \" -- ... 1,000 5:30 $5"
).split()


def synthetic_captions(num_images=24, seed=0):
    """({img_id: [{'caption': raw}]} references, the same for one candidate
    each): 5 references of 4 to 12 words an image, the candidate a corrupted
    first reference (an empty one among them)."""
    rng = np.random.default_rng(seed)
    gts, res = {}, {}
    for i in range(num_images):
        refs = [" ".join(rng.choice(WORDS, size=int(rng.integers(4, 13)))) for _ in range(5)]
        base = refs[0].split()
        k = int(rng.integers(0, len(base)))
        hyp = base[:k] + list(rng.choice(WORDS, size=max(1, len(base) - k)))
        gts[i] = [{"caption": r.capitalize() if j % 2 else r} for j, r in enumerate(refs)]
        res[i] = [{"caption": "" if i == 3 else " ".join(hyp)}]
    return gts, res


@pytest.fixture(scope="module")
def tokenized():
    gts, res = synthetic_captions()
    return ptok.tokenize_captions(gts), ptok.tokenize_captions(res)


@pytest.fixture
def no_jars(monkeypatch):
    for var in JARS:
        monkeypatch.delenv(var, raising=False)


def test_tokenizer_matches_jax(no_jars):
    gts, res = synthetic_captions()
    assert ptok.tokenize_captions(gts) == jtok.tokenize_captions(gts)
    assert ptok.tokenize_captions(res) == jtok.tokenize_captions(res)
    for c in (caps[0]["caption"] for caps in gts.values()):
        assert ptok.ptb_tokenize_sentence(c) == jtok.ptb_tokenize_sentence(c)
    assert ptok.PUNCTUATIONS == jtok.PUNCTUATIONS


@pytest.mark.parametrize("option", ["closest", "shortest", "average"])
def test_bleu_matches_jax(tokenized, option):
    gts, res = tokenized
    got, want = pbleu.BleuScorer(4), jbleu.BleuScorer(4)
    for i in gts:
        got.append(res[i][0], gts[i])
        want.append(res[i][0], gts[i])
    assert got.compute(option) == want.compute(option)
    if option == "closest":
        corpus, per_seg = pbleu.compute_bleu(gts, res)
        assert (corpus, per_seg) == jbleu.compute_bleu(gts, res)
        assert len(corpus) == 4 and len(per_seg[3]) == len(gts)


def test_rouge_matches_jax(tokenized):
    gts, res = tokenized
    got, want = prouge.compute_rouge(gts, res), jrouge.compute_rouge(gts, res)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("which", ["meteor", "spice"])
def test_native_scorers_match_jax(tokenized, which):
    gts, res = tokenized
    port, jax_ = {"meteor": (pmn.NativeMeteorScorer, jmn.NativeMeteorScorer),
                  "spice": (psn.NativeSpiceScorer, jsn.NativeSpiceScorer)}[which]
    got, want = port().compute(gts, res), jax_().compute(gts, res)
    assert got[0] == want[0] and 0.0 < got[0] < 1.0
    np.testing.assert_array_equal(got[1], want[1])


def test_native_scorer_pieces_match_jax(tokenized):
    """The stemmer, the METEOR segment score in both parameterizations and
    the SPICE scene graphs and F1, caption by caption."""
    gts, res = tokenized
    for i in gts:
        hyp, refs = res[i][0], gts[i]
        assert pmn.meteor_score(hyp, refs) == jmn.meteor_score(hyp, refs)
        assert pmn.meteor_score(hyp, refs, 0.9, 3, 0.5, 0.5, (1.0, 1.0, 1.0)) == \
            jmn.meteor_score(hyp, refs, 0.9, 3, 0.5, 0.5, (1.0, 1.0, 1.0))
        for cap in [hyp, *refs]:
            assert tuple(psn.parse_scene_graph(cap)) == tuple(jsn.parse_scene_graph(cap))
            assert [pmn.porter_stem(w) for w in cap.split()] == [
                jmn.porter_stem(w) for w in cap.split()]
        for synonyms in (True, False):
            assert psn.spice_score(hyp, refs, synonyms) == jsn.spice_score(hyp, refs, synonyms)


def test_harness_matches_jax(no_jars):
    """`evaluate_captions` with every metric and `CocoEvalCap`'s per-image
    table, on raw captions."""
    gts, res = synthetic_captions(seed=1)
    preds = {i: res[i][0]["caption"] for i in res}
    refs = {i: [c["caption"] for c in gts[i]] for i in gts}
    metrics = ("bleu", "meteor", "rouge", "cider", "spice")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = pharness.evaluate_captions(preds, refs, metrics=metrics)
        want = jharness.evaluate_captions(preds, refs, metrics=metrics)
        ev_p, ev_j = pharness.CocoEvalCap(gts, res), jharness.CocoEvalCap(gts, res)
        assert ev_p.evaluate(spice=True, meteor=True) == ev_j.evaluate(spice=True, meteor=True)
    assert got == want
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr",
                        "SPICE"}
    assert all(np.isfinite(v) for v in got.values())
    assert ev_p.imgToEval == ev_j.imgToEval


def test_harness_picks_native_scorers_and_warns_once(no_jars, monkeypatch):
    """No jar named: METEOR and SPICE come from the native scorers (the same
    numbers), each with one warning however many times the harness runs; the
    notice set is emptied first so that the test does not depend on what ran
    before it in this process."""
    monkeypatch.setattr(pharness, "_NATIVE_NOTICE_SHOWN", set())
    gts, res = synthetic_captions(num_images=6, seed=2)
    preds = {i: res[i][0]["caption"] for i in res}
    refs = {i: [c["caption"] for c in gts[i]] for i in gts}
    with warnings.catch_warnings(record=True) as first:
        warnings.simplefilter("always")
        scores = pharness.evaluate_captions(preds, refs, metrics=("meteor", "spice"))
    with warnings.catch_warnings(record=True) as second:
        warnings.simplefilter("always")
        pharness.evaluate_captions(preds, refs, metrics=("meteor", "spice"))
    notes = [str(w.message) for w in first]
    assert len(notes) == 2
    assert notes[0].startswith("METEOR: using the NATIVE scorer (METEOR_JAR not set).")
    assert notes[1].startswith("SPICE: using the NATIVE scorer (SPICE_JAR not set).")
    assert not second
    tg, tr = ptok.tokenize_captions(gts), ptok.tokenize_captions(res)
    assert scores["METEOR"] == pmn.NativeMeteorScorer().compute(tg, tr)[0]
    assert scores["SPICE"] == psn.NativeSpiceScorer().compute(tg, tr)[0]


@pytest.mark.parametrize("wrapper", ["meteor", "spice"])
def test_jar_wrappers_refuse_without_jar(no_jars, tmp_path, wrapper):
    port, jax_ = {"meteor": (pmeteor.MeteorScorer, jmeteor.MeteorScorer),
                  "spice": (pspice.SpiceScorer, jspice.SpiceScorer)}[wrapper]
    for path in (None, str(tmp_path / "missing.jar")):
        with pytest.raises(RuntimeError) as got:
            port(path)
        with pytest.raises(RuntimeError) as want:
            jax_(path)
        assert str(got.value) == str(want.value)
