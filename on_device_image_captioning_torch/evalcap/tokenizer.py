"""PTB-style caption tokenizer, native Python.

A copy of the JAX package's `evalcap/tokenizer.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

The reference shells out to Stanford CoreNLP's PTBTokenizer jar with -lowerCase
and then strips a punctuation list (reference eval/tokenizer/ptbtokenizer.py:42-113);
the jar is an external binary absent from the snapshot (.MISSING_LARGE_BLOBS), so
this module implements the Treebank tokenization rules that matter for caption text
directly: punctuation splitting, English contraction clitics ('s, n't, 'll, 've,
're, 'm, 'd), bracket normalization, lowercasing — followed by the same
punctuation-drop list.
"""
from __future__ import annotations

import re
from typing import Dict, List

PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_BRACKETS = {
    "(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
    "[": "-LRB-", "]": "-RRB-",
}

_RULES = [
    # opening single quote before a word -> ` (CoreNLP quote normalization);
    # must run before the clitic rules create space-quote sequences
    (re.compile(r"(^|[\s(\[{<])'(?=[A-Za-z])"), r"\1` "),
    # separate ellipses and standalone punctuation
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"([;@#$%])"), r" \1 "),
    # comma/colon stay inside numbers ("1,000", "5:30" are single PTB tokens)
    (re.compile(r"(?<!\d),"), r" , "),
    (re.compile(r",(?!\d)"), r" , "),
    (re.compile(r"(?<!\d):"), r" : "),
    (re.compile(r":(?!\d)"), r" : "),
    # ampersand stays inside names ("AT&T" is one CoreNLP token)
    (re.compile(r"(?<![A-Za-z0-9])&"), r" & "),
    (re.compile(r"&(?![A-Za-z0-9])"), r" & "),
    # final period (PTB splits sentence-final periods, keeps abbreviations; caption
    # text has no abbreviation periods after the eval pipeline strips them anyway)
    (re.compile(r"([^\.])(\.)(\s|$)"), r"\1 \2\3"),
    (re.compile(r"([?!])"), r" \1 "),
    (re.compile(r"([\]\[(){}<>])"), r" \1 "),
    (re.compile(r"--"), r" -- "),
    # assimilations (CoreNLP splitAssimilations, on by default)
    (re.compile(r"\b([Cc])annot\b"), r"\1an not"),
    (re.compile(r"\b([Gg])onna\b"), r"\1on na"),
    (re.compile(r"\b([Gg])otta\b"), r"\1ot ta"),
    (re.compile(r"\b([Ww])anna\b"), r"\1an na"),
    (re.compile(r"\b([Ll])emme\b"), r"\1em me"),
    (re.compile(r"\b([Gg])imme\b"), r"\1im me"),
    # possessive / contraction clitics
    (re.compile(r"([^' ])('[sSmMdD]|'ll|'LL|'re|'RE|'ve|'VE)(\s|$)"), r"\1 \2\3"),
    (re.compile(r"(\S)(n't|N'T)(\s|$)"), r"\1 \2\3"),
    # plural possessive / closing single quote after a word ("dogs'" -> dogs ')
    (re.compile(r"([A-Za-z0-9])'(?=\s|$)"), r"\1 ' "),
    # double quotes
    (re.compile(r'"'), r" '' "),
]


def ptb_tokenize_sentence(text: str) -> List[str]:
    text = text.replace("\n", " ")
    for pat, rep in _RULES:
        text = pat.sub(rep, text)
    tokens = []
    for tok in text.split():
        tok = _BRACKETS.get(tok, tok)
        tokens.append(tok.lower())
    return tokens


def tokenize_captions(captions_for_image: Dict) -> Dict[object, List[str]]:
    """{img_id: [{'caption': str}, ...]} -> {img_id: [tokenized strings]} with the
    punctuation list dropped, mirroring the reference wrapper's output shape
    (reference eval/tokenizer/ptbtokenizer.py:103-113).

    When CORENLP_JAR points at a Stanford CoreNLP jar (scripts/
    get_scorer_jars.sh), tokenization runs through the original Java
    PTBTokenizer instead — the jar stays authoritative for cross-checks, the
    native rules above are the offline default."""
    import os

    jar = os.environ.get("CORENLP_JAR")
    if jar:
        return _tokenize_captions_jar(captions_for_image, jar)
    out: Dict[object, List[str]] = {}
    for img_id, caps in captions_for_image.items():
        out[img_id] = [
            " ".join(
                w for w in ptb_tokenize_sentence(c["caption"]) if w not in PUNCTUATIONS
            )
            for c in caps
        ]
    return out


def _tokenize_captions_jar(captions_for_image: Dict, jar: str):
    """Subprocess protocol of the reference wrapper
    (reference eval/tokenizer/ptbtokenizer.py:46-113): one caption per line on
    a temp file, `java -cp <jar> edu.stanford.nlp.process.PTBTokenizer
    -preserveLines -lowerCase`, then the punctuation drop."""
    import os
    import subprocess
    import tempfile

    ids = [k for k, v in captions_for_image.items() for _ in range(len(v))]
    sentences = "\n".join(
        c["caption"].replace("\n", " ")
        for v in captions_for_image.values()
        for c in v
    )
    with tempfile.NamedTemporaryFile(
        "w", suffix=".tmp", delete=False, encoding="utf-8"
    ) as f:
        f.write(sentences)
        tmp = f.name
    try:
        proc = subprocess.run(
            ["java", "-cp", jar, "edu.stanford.nlp.process.PTBTokenizer",
             "-preserveLines", "-lowerCase", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, check=True,
        )
    finally:
        os.remove(tmp)
    lines = proc.stdout.decode("utf-8").split("\n")
    # seed every image id so caption-less ids keep an empty list, like the
    # native path
    out: Dict[object, List[str]] = {k: [] for k in captions_for_image}
    for k, line in zip(ids, lines):
        out[k].append(
            " ".join(w for w in line.rstrip().split(" ") if w not in PUNCTUATIONS)
        )
    return out
