"""COCO-caption evaluation harness.

A copy of the JAX package's `evalcap/harness.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

API-compatible rebuild of the reference's COCOEvalCap (reference eval/eval.py:17-117):
tokenize gts/res PTB-style, run the selected scorers, aggregate into `eval` /
`imgToEval` dicts. METEOR and SPICE require external Java jars that the reference
itself ships out-of-band (.MISSING_LARGE_BLOBS); they are optional here and
activate only when a jar path is configured (see meteor.py / spice.py).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import warnings

from .bleu import compute_bleu
from .cider import compute_cider
from .rouge import compute_rouge
from .tokenizer import tokenize_captions

_NATIVE_NOTICE_SHOWN = set()


def _native_notice(metric: str, jar_env: str, deviation: str) -> None:
    """One-time runtime notice when a native fallback scorer produces a
    standard metric name, so its numbers aren't compared against published
    jar-scored figures unawares."""
    if metric in _NATIVE_NOTICE_SHOWN:
        return
    _NATIVE_NOTICE_SHOWN.add(metric)
    warnings.warn(
        f"{metric}: using the NATIVE scorer ({jar_env} not set). "
        f"{deviation} Scores can read slightly lower than the Java "
        f"scorer's; set {jar_env} for jar-exact numbers.",
        stacklevel=3,
    )


class CocoEvalCap:
    """gts/res: {img_id: [{'image_id': id, 'caption': str}, ...]} — res holds one
    candidate per image."""

    def __init__(self, gts: Dict, res: Dict):
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict = {}
        self.gts_raw = gts
        self.res_raw = res

    def evaluate(
        self,
        bleu: bool = True,
        rouge: bool = True,
        cider: bool = True,
        spice: bool = False,
        meteor: bool = False,
        verbose: bool = False,
    ) -> Dict[str, float]:
        gts = tokenize_captions(self.gts_raw)
        res = tokenize_captions(self.res_raw)
        img_ids = list(gts.keys())

        if bleu:
            corpus, per_seg = compute_bleu(gts, res)
            for k, score in enumerate(corpus):
                self._set(f"Bleu_{k + 1}", score, img_ids, per_seg[k])
        if rouge:
            score, per_img = compute_rouge(gts, res)
            self._set("ROUGE_L", score, img_ids, per_img)
        if cider:
            score, per_img = compute_cider(gts, res)
            self._set("CIDEr", score, img_ids, per_img)
        if meteor:
            import os

            if os.environ.get("METEOR_JAR"):
                # the jar (when available) is authoritative: it adds the
                # WordNet-synonym and paraphrase matcher stages
                from .meteor import MeteorScorer

                scorer = MeteorScorer()
            else:
                from .meteor_native import NativeMeteorScorer

                _native_notice(
                    "METEOR", "METEOR_JAR",
                    "Matcher runs all four stages (exact/stem/synonym/"
                    "paraphrase) but the synonym and paraphrase tables "
                    "are embedded caption-domain stand-ins for the "
                    "jar's WordNet + paraphrase-en.gz data.",
                )
                scorer = NativeMeteorScorer()
            score, per_img = scorer.compute(gts, res)
            scorer.close()
            self._set("METEOR", score, img_ids, per_img)
        if spice:
            import os

            if os.environ.get("SPICE_JAR"):
                # the jar (when available) is authoritative: CoreNLP parsing
                # + WordNet-synset tuple matching
                from .spice import SpiceScorer

                scorer = SpiceScorer()
            else:
                from .spice_native import NativeSpiceScorer

                _native_notice(
                    "SPICE", "SPICE_JAR",
                    "Scene graphs come from the lexicon parser with "
                    "lemma/stem/embedded-synonym tuple matching, not "
                    "CoreNLP parsing + WordNet synsets.",
                )
                scorer = NativeSpiceScorer()
            score, per_img = scorer.compute(gts, res)
            self._set("SPICE", score, img_ids, per_img)
        if verbose:
            for k, v in self.eval.items():
                print(f"{k}: {v:.4f}", flush=True)
        return dict(self.eval)

    def _set(self, method: str, score: float, img_ids: Sequence, per_img) -> None:
        self.eval[method] = float(score)
        for i, img_id in enumerate(img_ids):
            self.imgToEval.setdefault(img_id, {"image_id": img_id})[method] = float(
                per_img[i]
            )


def evaluate_captions(
    predictions: Dict[object, str],
    references: Dict[object, List[str]],
    metrics: Sequence[str] = ("bleu", "rouge", "cider"),
    verbose: bool = False,
) -> Dict[str, float]:
    """Convenience wrapper over CocoEvalCap for plain {id: caption} predictions."""
    gts = {i: [{"caption": c} for c in refs] for i, refs in references.items()}
    res = {i: [{"caption": predictions[i]}] for i in references.keys()}
    ev = CocoEvalCap(gts, res)
    return ev.evaluate(
        bleu="bleu" in metrics,
        rouge="rouge" in metrics,
        cider="cider" in metrics,
        spice="spice" in metrics,
        meteor="meteor" in metrics,
        verbose=verbose,
    )
