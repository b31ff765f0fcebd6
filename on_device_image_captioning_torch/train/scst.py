"""SCST reward computation on the host: CIDEr over sampled captions with a
frozen training document-frequency corpus (counterpart of the JAX package's
`train/scst.py`).

Rebuild of the reference's reward pipeline (reference losses/reward.py:8-89 +
eval/cider/reinforce_cider.py): all training references are preprocessed once in
the constructor (cheap regex pipeline, not the PTB jar) with EOS appended; each
batch scores `num_samples` sampled captions per image against that image's
references using document frequencies precomputed over the whole training corpus.

The reward runs on the host between the device-side sampling call and the
device-side gradient step (see train_step.make_scst_step): strings never touch
the card. `train/device_cider.py` computes the same scores on the card.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..data.text import Vocab, clean_caption
from ..evalcap.cider import CiderCorpus


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else x


class CiderReward:
    def __init__(
        self,
        training_references: Sequence[List[str]],
        eos_token: str = "EOS",
        use_native: str = "auto",
    ):
        """use_native: 'auto' picks the C++ scorer (native/cider.cc) when g++
        built it, else the Python scorer; 'always' raises where it could not
        be built; 'never' forces the Python scorer (identical numerics, see
        tests/test_torch_cider.py)."""
        processed = [
            [clean_caption(c) + " " + eos_token for c in refs]
            for refs in training_references
        ]
        self.corpus = None
        if use_native in ("auto", "always"):
            try:
                from ..evalcap.cider_native import NativeCiderCorpus

                if NativeCiderCorpus.available() or use_native == "always":
                    self.corpus = NativeCiderCorpus(processed)
            except (OSError, RuntimeError, ValueError):
                if use_native == "always":
                    raise
        if self.corpus is None:
            self.corpus = CiderCorpus(processed)
        self.eos_token = eos_token

    def __call__(
        self, sampled_tokens: np.ndarray, lengths: np.ndarray, image_indices, vocab: Vocab
    ) -> np.ndarray:
        """sampled_tokens: (B, N, L+1) int with SOS prefix; lengths: (B, N) index
        of first EOS; image_indices: (B,) indices into the training corpus
        (numpy arrays, or tensors, which are read on the host).
        Returns rewards (B, N).

        The SOS token is dropped but EOS is kept in the scored string — the
        reference calls this out as important for correct SCST credit assignment
        (reference losses/reward.py:40-45).
        """
        sampled_tokens, lengths = np.asarray(_host(sampled_tokens)), np.asarray(_host(lengths))
        b, n, _ = sampled_tokens.shape
        hyps, ref_idx = [], []
        for i in range(b):
            for j in range(n):
                toks = sampled_tokens[i, j, 1 : lengths[i, j] + 1].tolist()
                hyps.append(" ".join(vocab.idx2word[t] for t in toks))
                ref_idx.append(int(image_indices[i]))
        scores = self.corpus.score_hypotheses(hyps, ref_idx)
        return scores.reshape(b, n).astype(np.float32)
