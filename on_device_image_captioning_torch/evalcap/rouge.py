"""ROUGE-L, coco-caption compatible (reference eval/rouge/rouge.py:14-110).

A copy of the JAX package's `evalcap/rouge.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

Per image: LCS-based precision/recall against each reference, max over references,
F-measure with beta=1.2; corpus score is the mean. The LCS here is O(len_a*len_b)
DP over numpy rows instead of nested Python lists.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BETA = 1.2


def lcs_length(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return 0
    prev = np.zeros(len(b) + 1, dtype=np.int32)
    for i in range(1, len(a) + 1):
        cur = np.zeros(len(b) + 1, dtype=np.int32)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return int(prev[-1])


def rouge_l(candidate: str, references: List[str]) -> float:
    hyp = candidate.split(" ")
    precs, recs = [], []
    for ref in references:
        r = ref.split(" ")
        lcs = lcs_length(r, hyp)
        precs.append(lcs / float(len(hyp)))
        recs.append(lcs / float(len(r)))
    p, r = max(precs), max(recs)
    if p != 0 and r != 0:
        return ((1 + BETA**2) * p * r) / float(r + BETA**2 * p)
    return 0.0


def compute_rouge(
    gts: Dict[object, List[str]], res: Dict[object, List[str]]
) -> Tuple[float, np.ndarray]:
    scores = []
    for img_id in gts:
        assert len(res[img_id]) == 1
        scores.append(rouge_l(res[img_id][0], gts[img_id]))
    arr = np.asarray(scores)
    return float(arr.mean()), arr
