"""Vocabulary and caption cleaning (the part of the JAX package's
`data/text.py` that the demo and the SCST rewards need: token ids to a display
caption, and the reference's caption cleaning; vocabulary building comes with
the data loaders)."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

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
