"""Vocabulary and caption text processing.

A copy of the JAX package's `data/text.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

Rebuild of the reference's language utilities (reference utils/language_utils.py)
and the COCO vocabulary convention (reference data/coco_dataset.py:127-181): tokens
are lowercased, non-alphanumeric symbols are space-separated, a punctuation list is
dropped, words under a minimum occurrence count map to UNK, and the vocabulary is
the sorted unique word list — which pins PAD/SOS/EOS/UNK at indices 78/79/77/80 for
the shipped 10k COCO vocab (verified against vocab/coco_vocab_idx_dict.json).
"""
from __future__ import annotations

import json
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence

PAD_TOKEN = "PAD"
SOS_TOKEN = "SOS"
EOS_TOKEN = "EOS"
UNK_TOKEN = "UNK"

_PUNCTUATIONS = {
    "''", "'", "``", "`", ".", "?", "!", ",", ":", "-", "--", "...", ";",
}


def clean_caption(text: str) -> str:
    """lowercase, strip trailing space, space out non-alphanumerics, drop
    punctuation tokens (reference utils/language_utils.py:16-57)."""
    text = text.lower().rstrip()
    text = re.sub(r"([^\w0-9])", r" \1 ", text)
    words = [w for w in text.split(" ") if w and w not in _PUNCTUATIONS]
    return " ".join(words)


def tokenize(text: str) -> List[str]:
    return [w for w in clean_caption(text).split(" ") if w]


@dataclass
class Vocab:
    word2idx: Dict[str, int]
    idx2word: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.idx2word:
            self.idx2word = [None] * len(self.word2idx)
            for w, i in self.word2idx.items():
                self.idx2word[i] = w

    def __len__(self):
        return len(self.word2idx)

    @property
    def pad_idx(self) -> int:
        return self.word2idx[PAD_TOKEN]

    @property
    def sos_idx(self) -> int:
        return self.word2idx[SOS_TOKEN]

    @property
    def eos_idx(self) -> int:
        return self.word2idx[EOS_TOKEN]

    @property
    def unk_idx(self) -> int:
        return self.word2idx[UNK_TOKEN]

    def encode(self, words: Sequence[str]) -> List[int]:
        unk = self.unk_idx
        return [self.word2idx.get(w, unk) for w in words]

    def encode_caption(self, text: str) -> List[int]:
        """SOS + tokens + EOS (reference data/coco_dataset.py caption framing)."""
        return [self.sos_idx] + self.encode(tokenize(text)) + [self.eos_idx]

    def decode(self, idxs: Iterable[int]) -> List[str]:
        return [self.idx2word[i] for i in idxs]

    def description(self, tokens: Sequence[int]) -> str:
        """tokens -> display sentence: drop SOS, stop at EOS, trailing period,
        capitalized (reference utils/language_utils.py:82-93)."""
        words = []
        for t in tokens:
            if t == self.sos_idx:
                continue
            if t == self.eos_idx:
                break
            words.append(self.idx2word[t])
        if not words:
            return ""
        words[-1] = words[-1] + "."
        return " ".join(words).capitalize()

    @classmethod
    def from_json(cls, path: str) -> "Vocab":
        """Load the reference's vocab/coco_vocab_idx_dict.json format."""
        with open(path) as f:
            return cls(word2idx=json.load(f))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.word2idx, f)

    @classmethod
    def build(cls, captions: Iterable[str], min_occurrences: int = 5) -> "Vocab":
        """Build from a caption corpus: words with >= min_occurrences, plus the four
        specials, sorted alphabetically (reference data/coco_dataset.py:127-181 —
        sorting is what fixes the special-token indices)."""
        counts = Counter()
        for c in captions:
            counts.update(tokenize(c))
        words = {w for w, n in counts.items() if n >= min_occurrences}
        words.update({PAD_TOKEN, SOS_TOKEN, EOS_TOKEN, UNK_TOKEN})
        idx2word = sorted(words)
        return cls(word2idx={w: i for i, w in enumerate(idx2word)}, idx2word=idx2word)


def pad_batch(seqs: Sequence[Sequence[int]], pad_value: int):
    """Right-pad to the in-batch max; returns (padded lists, num_pads per row)
    (reference data/transparent_data_loader.py:63-77)."""
    max_len = max(len(s) for s in seqs)
    padded = [list(s) + [pad_value] * (max_len - len(s)) for s in seqs]
    num_pads = [max_len - len(s) for s in seqs]
    return padded, num_pads


def compute_num_pads(seqs: Sequence[Sequence]) -> List[int]:
    """(reference utils/language_utils.py:4-13)."""
    max_len = max(len(s) for s in seqs)
    return [max_len - len(s) for s in seqs]
