"""Corpus BLEU 1-4, coco-caption compatible.

A copy of the JAX package's `evalcap/bleu.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

Same math as the reference's BleuScorer (reference eval/bleu/bleu_scorer.py):
clipped n-gram precision with tiny/small stabilizers, effective reference length
('closest' by default for multi-segment corpora, tie broken toward the shorter
reference), and the brevity penalty applied both per segment and corpus-wide.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_TINY = 1e-15
_SMALL = 1e-9


def _ngrams(words: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(words[i : i + k]) for k in range(1, n + 1) for i in range(len(words) - k + 1)
    )


def _closest_reflen(reflens: List[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


class BleuScorer:
    """Accumulates (hypothesis, references) segments; scores the corpus."""

    def __init__(self, n: int = 4):
        self.n = n
        self._segments: List[Tuple[List[str], List[List[str]]]] = []

    def append(self, hypothesis: str, references: Sequence[str]) -> None:
        self._segments.append(
            (hypothesis.split(), [r.split() for r in references])
        )

    def compute(self, option: str = None) -> Tuple[List[float], List[List[float]]]:
        """Returns (corpus scores [B1..Bn], per-segment scores [n][num_segments])."""
        if option is None:
            option = "average" if len(self._segments) == 1 else "closest"
        n = self.n
        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        seg_scores: List[List[float]] = [[] for _ in range(n)]

        for hyp, refs in self._segments:
            testlen = len(hyp)
            reflens = [len(r) for r in refs]
            if option == "shortest":
                reflen: float = min(reflens)
            elif option == "average":
                reflen = sum(reflens) / len(reflens)
            else:
                reflen = _closest_reflen(reflens, testlen)
            total_testlen += testlen
            total_reflen += reflen

            maxcounts: Counter = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    maxcounts[ng] = max(maxcounts[ng], c)
            counts = _ngrams(hyp, n)
            guess = [max(0, testlen - k) for k in range(n)]
            correct = [0] * n
            for ng, c in counts.items():
                correct[len(ng) - 1] += min(c, maxcounts[ng])

            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            bleu = 1.0
            ratio = (testlen + _TINY) / (reflen + _SMALL)
            for k in range(n):
                bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                s = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    s *= math.exp(1 - 1 / ratio)
                seg_scores[k].append(s)

        corpus = []
        bleu = 1.0
        ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
        for k in range(n):
            bleu *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            s = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            corpus.append(s)
        return corpus, seg_scores


def compute_bleu(
    gts: Dict[object, List[str]], res: Dict[object, List[str]], n: int = 4
) -> Tuple[List[float], List[List[float]]]:
    """coco-caption Bleu.compute_score API: gts/res map img_id -> tokenized caption
    strings, res has exactly one hypothesis per image."""
    scorer = BleuScorer(n)
    for img_id in gts:
        assert len(res[img_id]) == 1
        scorer.append(res[img_id][0], gts[img_id])
    return scorer.compute("closest")
