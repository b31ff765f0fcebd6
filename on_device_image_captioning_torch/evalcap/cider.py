"""CIDEr(-D), coco-caption compatible (reference eval/cider/cider_scorer.py);
a copy of the JAX package's `evalcap/cider.py`, which is plain numpy.

TF-IDF cosine over 1..4-grams with count clipping and the sigma=6 gaussian length
penalty. Two faithfully-preserved quirks of the original:
- `length` counts BIGRAM positions (the `if n == 1` branch at
  reference eval/cider/cider_scorer.py:135-136), so the gaussian penalty compares
  len(words)-1 values;
- IDF document frequency comes from the evaluation corpus itself with
  ref_len = log(num_images).

`CiderCorpus` also supports a frozen document-frequency corpus for SCST rewards,
where DF is precomputed once over all training references and reused per batch
(reference eval/cider/reinforce_cider.py:18-53).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

N = 4
SIGMA = 6.0


def _ngram_counts(sentence: str) -> Counter:
    words = sentence.split()
    return Counter(
        tuple(words[i : i + k]) for k in range(1, N + 1) for i in range(len(words) - k + 1)
    )


class CiderCorpus:
    """Document frequencies + log corpus size, reusable across compute calls."""

    def __init__(self, refs_per_image: Sequence[List[str]]):
        self.doc_freq: Dict[tuple, float] = defaultdict(float)
        self.cooked_refs = [
            [_ngram_counts(r) for r in refs] for refs in refs_per_image
        ]
        for refs in self.cooked_refs:
            for ng in set(ng for ref in refs for ng in ref):
                self.doc_freq[ng] += 1
        self.log_ref_len = np.log(float(len(self.cooked_refs)))

    def _vec(self, counts: Counter):
        vec = [defaultdict(float) for _ in range(N)]
        norm = [0.0] * N
        length = 0
        for ng, tf in counts.items():
            df = np.log(max(1.0, self.doc_freq[ng]))
            k = len(ng) - 1
            vec[k][ng] = float(tf) * (self.log_ref_len - df)
            norm[k] += vec[k][ng] ** 2
            if k == 1:  # bigram-count length quirk, see module docstring
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, vr, nh, nr, lh, lr) -> np.ndarray:
        delta = float(lh - lr)
        val = np.zeros(N)
        for k in range(N):
            for ng in vh[k]:
                val[k] += min(vh[k][ng], vr[k][ng]) * vr[k][ng]
            if nh[k] != 0 and nr[k] != 0:
                val[k] /= nh[k] * nr[k]
            val[k] *= math.exp(-(delta**2) / (2 * SIGMA**2))
        return val

    def score_hypotheses(
        self, hypotheses: Sequence[str], ref_indices: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        """Score hypothesis i against cooked_refs[ref_indices[i]] (identity map by
        default). Returns per-image CIDEr scores (x10)."""
        if ref_indices is None:
            ref_indices = range(len(hypotheses))
        scores = []
        for hyp, ridx in zip(hypotheses, ref_indices):
            vec, norm, length = self._vec(_ngram_counts(hyp))
            acc = np.zeros(N)
            refs = self.cooked_refs[ridx]
            for ref in refs:
                vr, nr, lr = self._vec(ref)
                acc += self._sim(vec, vr, norm, nr, length, lr)
            scores.append(float(np.mean(acc)) / len(refs) * 10.0)
        return np.asarray(scores)


def compute_cider(
    gts: Dict[object, List[str]], res: Dict[object, List[str]]
) -> Tuple[float, np.ndarray]:
    """coco-caption Cider.compute_score API."""
    ids = list(gts.keys())
    corpus = CiderCorpus([gts[i] for i in ids])
    hyps = []
    for i in ids:
        assert len(res[i]) == 1
        hyps.append(res[i][0])
    scores = corpus.score_hypotheses(hyps)
    return float(scores.mean()), scores
