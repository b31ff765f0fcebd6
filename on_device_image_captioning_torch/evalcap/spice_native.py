"""Native SPICE scorer — scene-graph tuple F1 without the Java toolchain.

A copy of the JAX package's `evalcap/spice_native.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

The reference's SPICE is a subprocess wrapper around spice-1.0.jar (reference
eval/spice/spice.py:18-126), which parses captions with CoreNLP into scene
graphs (objects / attributes / relations) and scores the candidate graph
against the union of the reference graphs by tuple F1 (Anderson et al. 2016,
arXiv:1607.08822). The jar and its CoreNLP models are external binaries absent
from the snapshot, so — like evalcap/meteor_native.py for METEOR — this module
reimplements the metric natively so SPICE numbers are obtainable without
them. The jar (SPICE_JAR) stays authoritative when present.

Pipeline (captions arrive lowercase PTB-tokenized from the harness):

1. POS tagging: closed-class lexicons (determiners, prepositions, copulas,
   conjunctions, numbers) + a caption-domain verb lexicon expanded through its
   inflections + adjective lexicon/suffixes; unknown "-ing" words are verbs
   unless in a noun exception list; everything else is a noun. Captions are
   short declarative NPs, so a lexicon tagger covers them well.
2. Chunking: noun phrases (DT? (ADJ|NUM|VBG|NN)* NN_head), with prenominal
   adjectives/numbers/participles and compound-noun prefixes becoming
   attributes of the head — matching the published SPICE example where
   "a tennis court" yields the attribute (court, tennis).
3. Relations: NP (VERB)? (PREP)? NP patterns — "a man riding a horse" ->
   (man, ride, horse); "a girl on top of a court" -> (girl, on top of, court);
   "a man riding on a beach" -> (man, ride on, beach). Copulas are skipped
   ("is riding" -> riding); predicative adjectives become attributes
   ("the horse is brown" -> (horse, brown)); a trailing verb with no object
   becomes an attribute ("a man smiling" -> (man, smile)), and conjunctions
   distribute ("a man and a woman walking" -> both subjects).
4. Lemmatization: rule-based plural/inflection stripping with irregular
   tables. Both candidate and reference pass through the same parser, so
   systematic parse conventions cancel in the F1.
5. Score: per image, tuples T = objects ∪ attributes ∪ relations;
   P = |T(c) ∩ T(refs)| / |T(c)|, R over the union of reference tuples,
   SPICE = F1, corpus score = mean per-image F1 — the same aggregation the
   jar's "All.f" output feeds through the reference harness.

Documented deviation: the jar matches tuples through WordNet synsets; with no
WordNet corpus at hand, matching here is exact on lemmas, then a
Porter-stem fallback (evalcap/meteor_native.porter_stem), then element-wise
shared-synonym-group equivalence over the embedded caption-domain table
(meteor_native.SYNONYM_GROUPS). WordNet pairs outside that table still miss,
which is stricter —
native scores read slightly lower than jar scores on the same captions.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, NamedTuple, Sequence, Tuple

import numpy as np

from .meteor_native import _NO_SYN, _SYN_IDS, porter_stem

# --------------------------------------------------------------------------
# Lexicons
# --------------------------------------------------------------------------

DETERMINERS = frozenset(
    "a an the this that these those some any no each every all both another "
    "several many few most other its his her their our my your".split()
)

# multiword prepositions checked longest-first at parse time
MULTIWORD_PREPS = (
    ("on", "top", "of"),
    ("in", "front", "of"),
    ("next", "to"),
    ("out", "of"),
    ("close", "to"),
)

PREPOSITIONS = frozenset(
    "in on at with by near under over above below behind beside between "
    "through across against along around atop inside outside onto into off "
    "down up toward towards during beneath underneath amongst among upon "
    "of for from to".split()
)

CONJUNCTIONS = frozenset(("and", "or"))

COPULAS = frozenset("is are was were be been being".split())
AUXILIARIES = frozenset("has have had do does did".split())

PRONOUNS = frozenset("it he she they someone something who which that".split())

NUMBER_WORDS = frozenset(
    "one two three four five six seven eight nine ten eleven twelve couple "
    "dozen".split()
)

# caption-domain base verbs; inflected forms are generated below
VERB_LEXICON = frozenset(
    """sit stand walk ride hold wear play eat drink look fly jump run surf
    ski skate snowboard skateboard drive carry cut talk watch hit throw catch
    swing pose smile lay lie hang park graze perch rest sleep read write cook
    bake serve feed pet brush wash swim race climb slide point reach lean
    kneel bend stretch wave cross pull push open close use make take give go
    come move work travel stare gaze grab touch kick sail row paddle pedal
    land glide soar dive splash chase herd pull lead walk guide prepare chop
    slice pour mix stir grill fry toss juggle balance perform dance sing
    stand wait board exit enter leave approach pass overlook surround cover
    fill contain display show decorate top line attach tie wrap stack pile
    arrange place set put load unload pick lift drop toss flip spin turn
    face smell sniff lick bite chew drink nurse cuddle hug kiss pat"""
    .split()
)

# -ing words that are (almost always) nouns in captions
ING_NOUNS = frozenset(
    "building painting clothing ceiling icing railing dressing crossing "
    "landing lightning morning evening wedding thing something anything "
    "nothing everything king ring spring string wing".split()
)

ADJ_LEXICON = frozenset(
    """red blue green yellow black white brown gray grey orange purple pink
    golden silver dark light bright colorful big large small little tall
    short long tiny huge giant wide narrow thin thick young old elderly new
    vintage modern antique open closed empty full busy crowded clean dirty
    wet dry snowy sunny cloudy rainy foggy grassy sandy rocky beautiful cute
    pretty happy sad angry lone single double triple wooden metal plastic
    leather furry fluffy shiny fresh delicious ripe raw hot cold warm frozen
    blurry distant nearby upside overhead asleep awake bare blonde brunette
    striped spotted checkered plaid floral shirtless barefoot airborne
    parallel perpendicular several different various assorted miniature"""
    .split()
)

# -able/-ible excluded: too many caption nouns end in them (table, vegetable)
_ADJ_SUFFIXES = ("ful", "ous", "less")

# irregular noun plurals -> singular
IRREGULAR_NOUNS = {
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "mice": "mouse", "geese": "goose",
    "sheep": "sheep", "deer": "deer", "fish": "fish", "cacti": "cactus",
    "knives": "knife", "wolves": "wolf", "shelves": "shelf",
    "leaves": "leaf", "loaves": "loaf", "scarves": "scarf",
    "cookies": "cookie", "skis": "ski", "buses": "bus", "dishes": "dish",
    "glasses": "glass", "benches": "bench", "sandwiches": "sandwich",
    "beaches": "beach", "couches": "couch", "watches": "watch",
    "boxes": "box", "foxes": "fox", "giraffes": "giraffe",
}

# plural-only nouns kept as-is
_KEEP_PLURAL = frozenset(
    "pants jeans shorts scissors pliers sunglasses tennis grass bus "
    "across gas this his its press dress chess".split()
)

# irregular verb forms -> base
IRREGULAR_VERBS = {
    "sat": "sit", "stood": "stand", "held": "hold", "wore": "wear",
    "worn": "wear", "ate": "eat", "eaten": "eat", "rode": "ride",
    "ridden": "ride", "flew": "fly", "flown": "fly", "ran": "run",
    "drove": "drive", "driven": "drive", "hung": "hang", "slept": "sleep",
    "fed": "feed", "lay": "lie", "lying": "lie", "laying": "lay",
    "threw": "throw", "thrown": "throw", "caught": "catch", "swung": "swing",
    "took": "take", "taken": "take", "gave": "give", "given": "give",
    "went": "go", "gone": "go", "came": "come", "made": "make",
    "wrote": "write", "written": "write", "read": "read", "led": "lead",
    "swam": "swim", "swum": "swim", "drank": "drink", "drunk": "drink",
    "bit": "bite", "bitten": "bite", "put": "put", "set": "set",
    "cut": "cut", "hit": "hit", "left": "leave", "lit": "light",
}

_VOWELS = "aeiou"


def _expand_verb_forms() -> Dict[str, str]:
    """inflected form -> base for every lexicon verb (s/es/ing/ed rules with
    consonant doubling and silent-e restoration)."""
    forms: Dict[str, str] = {}
    for base in VERB_LEXICON:
        forms[base] = base
        # third person singular
        if base.endswith(("s", "sh", "ch", "x", "z", "o")):
            forms[base + "es"] = base
        elif base.endswith("y") and base[-2] not in _VOWELS:
            forms[base[:-1] + "ies"] = base
        else:
            forms[base + "s"] = base
        # -ing / -ed
        if base.endswith("e") and not base.endswith("ee"):
            stemmed = base[:-1]
            forms[stemmed + "ing"] = base
            forms[stemmed + "ed"] = base
        else:
            doubled = base
            if (
                len(base) >= 3
                and base[-1] not in _VOWELS + "wxy"
                and base[-2] in _VOWELS
                and base[-3] not in _VOWELS
            ):
                doubled = base + base[-1]
            forms[doubled + "ing"] = base
            if base.endswith("y") and base[-2] not in _VOWELS:
                forms[base[:-1] + "ied"] = base
            else:
                forms[doubled + "ed"] = base
    forms.update(IRREGULAR_VERBS)
    return forms


VERB_FORMS = _expand_verb_forms()


def lemmatize_noun(word: str) -> str:
    if word in IRREGULAR_NOUNS:
        return IRREGULAR_NOUNS[word]
    if word in _KEEP_PLURAL or len(word) <= 3:
        return word
    if word.endswith("ies"):
        return word[:-3] + "y"
    # "-ses" deliberately NOT stripped to "es": horses/houses/noses are
    # singular+s; bus-type plurals are in IRREGULAR_NOUNS
    if word.endswith(("sses", "xes", "ches", "shes", "zes", "oes")):
        return word[:-2]
    if word.endswith("s") and not word.endswith(("ss", "us", "is")):
        return word[:-1]
    return word


def lemmatize_verb(word: str) -> str:
    if word in VERB_FORMS:
        return VERB_FORMS[word]
    if word in IRREGULAR_VERBS:
        return IRREGULAR_VERBS[word]
    if word.endswith("ing") and len(word) > 5:
        stem = word[:-3]
        if len(stem) >= 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            return stem[:-1]  # running -> run
        if stem and stem[-1] not in _VOWELS and len(stem) >= 2 and stem[-2] in _VOWELS:
            # riding -> ride? only when the e-form looks more like a word —
            # unknowable without a dictionary; keep the bare stem (consistent
            # on both sides of the F1)
            return stem
        return stem
    if word.endswith("ed") and len(word) > 4:
        stem = word[:-2]
        if len(stem) >= 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            return stem[:-1]
        return stem
    if word.endswith("ies") and len(word) > 4:
        return word[:-3] + "y"
    if word.endswith("es") and word.endswith(("ses", "xes", "ches", "shes")):
        return word[:-2]
    if word.endswith("s") and not word.endswith("ss"):
        return word[:-1]
    return word


# --------------------------------------------------------------------------
# Tagging
# --------------------------------------------------------------------------

# tags: DT IN CC AUX NUM JJ VB NN PRP
def tag_tokens(tokens: Sequence[str]) -> List[str]:
    tags: List[str] = []
    for w in tokens:
        if w in DETERMINERS:
            tags.append("DT")
        elif w in COPULAS or w in AUXILIARIES:
            tags.append("AUX")
        elif w in PREPOSITIONS:
            tags.append("IN")
        elif w in CONJUNCTIONS:
            tags.append("CC")
        elif w in NUMBER_WORDS or w.isdigit():
            tags.append("NUM")
        elif w in PRONOUNS:
            tags.append("PRP")
        elif w in VERB_FORMS:
            tags.append("VB")
        elif w in ADJ_LEXICON or w.endswith(_ADJ_SUFFIXES):
            tags.append("JJ")
        elif w.endswith("ing") and w not in ING_NOUNS and len(w) > 4:
            tags.append("VB")
        else:
            tags.append("NN")
    # contextual fixup: a verb form directly modifying a following noun acts
    # as a participial adjective ("a standing man", "a parked car") when the
    # previous token opens an NP
    for i in range(len(tags)):
        if tags[i] == "VB" and i + 1 < len(tags) and tags[i + 1] in ("NN", "JJ", "NUM"):
            if i == 0 or tags[i - 1] in ("DT", "JJ", "NUM", "CC", "IN"):
                tags[i] = "JJ"
    return tags


# --------------------------------------------------------------------------
# Parsing
# --------------------------------------------------------------------------


class SceneGraph(NamedTuple):
    objects: FrozenSet[Tuple[str, ...]]
    attributes: FrozenSet[Tuple[str, ...]]
    relations: FrozenSet[Tuple[str, ...]]

    def tuples(self) -> FrozenSet[Tuple[str, ...]]:
        return self.objects | self.attributes | self.relations


class _NP(NamedTuple):
    heads: List[str]  # lemmatized head nouns (conjunctions give several)
    attrs: List[Tuple[str, str]]  # (head, attribute)


def _parse_np(tokens, tags, i):
    """Parse an NP starting at i. Returns (_NP, next_index) or (None, i)."""
    n = len(tokens)
    start = i
    if i < n and tags[i] == "DT":
        i += 1
    mods: List[str] = []
    nouns: List[str] = []
    while i < n and tags[i] in ("JJ", "NUM", "NN", "PRP"):
        if tags[i] in ("JJ", "NUM"):
            # only prenominal: require a noun later in the chunk
            j = i + 1
            while j < n and tags[j] in ("JJ", "NUM"):
                j += 1
            if j < n and tags[j] in ("NN", "PRP"):
                word = tokens[i]
                if tags[i] == "JJ" and tokens[i].endswith("ing"):
                    word = lemmatize_verb(word)
                mods.append(word)
                i += 1
            else:
                break
        else:
            nouns.append(tokens[i])
            i += 1
            # compound noun continues only while the next token is also NN
            if i < n and tags[i] in ("NN", "PRP"):
                continue
            break
    if not nouns:
        return None, start
    head = lemmatize_noun(nouns[-1])
    attrs = [(head, m) for m in mods]
    # compound prefixes become attributes of the head: "tennis court" ->
    # (court, tennis) — the published SPICE parse convention
    for prefix in nouns[:-1]:
        attrs.append((head, lemmatize_noun(prefix)))
    np_ = _NP(heads=[head], attrs=attrs)
    # conjoined NP: "a man and a woman"
    if i < n and tags[i] == "CC":
        nxt, j = _parse_np(tokens, tags, i + 1)
        if nxt is not None:
            np_ = _NP(heads=np_.heads + nxt.heads, attrs=np_.attrs + nxt.attrs)
            i = j
    return np_, i


def _match_prep(tokens, tags, i):
    """Longest preposition (multiword first) at i, or (None, i)."""
    for mw in MULTIWORD_PREPS:
        if tuple(tokens[i : i + len(mw)]) == mw:
            return " ".join(mw), i + len(mw)
    if i < len(tokens) and tags[i] == "IN":
        return tokens[i], i + 1
    return None, i


def parse_scene_graph(caption: str) -> SceneGraph:
    """Caption (lowercase, tokenized text) -> scene graph of lemma tuples."""
    tokens = caption.split()
    tags = tag_tokens(tokens)
    n = len(tokens)
    objects: set = set()
    attributes: set = set()
    relations: set = set()

    i = 0
    subjects: List[str] = []  # current subject heads for relation attachment
    pending_verb: str | None = None  # verb awaiting an object
    while i < n:
        prep, j = _match_prep(tokens, tags, i)
        if prep is not None and subjects:
            np_, k = _parse_np(tokens, tags, j)
            if np_ is not None:
                for h in np_.heads:
                    objects.add((h,))
                attributes.update(np_.attrs)
                rel = f"{pending_verb} {prep}" if pending_verb else prep
                for s in subjects:
                    for o in np_.heads:
                        relations.add((s, rel, o))
                pending_verb = None
                # the object NP becomes the attachment point for what follows
                # ("a man on a horse in a field" -> (horse, in, field))
                subjects = np_.heads
                i = k
                continue
            i = j
            continue
        if tags[i] == "AUX":
            # skip copulas/auxiliaries; predicative adjective -> attribute
            j = i + 1
            if j < n and tags[j] == "JJ" and (j + 1 >= n or tags[j + 1] not in ("NN", "PRP")):
                for s in subjects:
                    attributes.add((s, tokens[j]))
                i = j + 1
                continue
            i = j
            continue
        if tags[i] == "VB":
            verb = lemmatize_verb(tokens[i])
            np_, k = _parse_np(tokens, tags, i + 1)
            if np_ is not None:
                for h in np_.heads:
                    objects.add((h,))
                attributes.update(np_.attrs)
                for s in subjects:
                    for o in np_.heads:
                        relations.add((s, verb, o))
                subjects = np_.heads
                i = k
            else:
                prep2, j2 = _match_prep(tokens, tags, i + 1)
                if prep2 is not None:
                    pending_verb = verb
                    i = i + 1
                else:
                    # verb with no object: attribute ("a man smiling")
                    for s in subjects:
                        attributes.add((s, verb))
                    i = i + 1
            continue
        np_, k = _parse_np(tokens, tags, i)
        if np_ is not None:
            for h in np_.heads:
                objects.add((h,))
            attributes.update(np_.attrs)
            subjects = np_.heads
            pending_verb = None
            i = k
            continue
        i += 1

    return SceneGraph(
        objects=frozenset(objects),
        attributes=frozenset(attributes),
        relations=frozenset(relations),
    )


# --------------------------------------------------------------------------
# Scoring
# --------------------------------------------------------------------------


def _stem_key(t: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(" ".join(porter_stem(w) for w in part.split()) for part in t)


def _words_match(a: str, b: str) -> bool:
    """Word equivalence for tuple matching: exact, Porter-stem, or shared
    caption-domain synonym group (meteor_native.SYNONYM_GROUPS standing in
    for the jar's WordNet synsets, reference eval/spice/spice.py:80-98)."""
    if a == b or porter_stem(a) == porter_stem(b):
        return True
    return bool(_SYN_IDS.get(a, _NO_SYN) & _SYN_IDS.get(b, _NO_SYN))


def _tuples_match(ta: Tuple[str, ...], tb: Tuple[str, ...]) -> bool:
    if len(ta) != len(tb):
        return False
    for pa, pb in zip(ta, tb):
        wa, wb = pa.split(), pb.split()
        if len(wa) != len(wb) or not all(
            _words_match(x, y) for x, y in zip(wa, wb)
        ):
            return False
    return True


def _f1(
    cand: FrozenSet[Tuple[str, ...]],
    ref: FrozenSet[Tuple[str, ...]],
    synonyms: bool = True,
):
    if not cand or not ref:
        return 0.0, 0.0, 0.0
    exact = cand & ref
    rem_c = sorted(cand - exact)
    rem_r = sorted(ref - exact)
    matched = len(exact)
    # stem-fallback matching for the remainder — one-to-one on stem keys
    rem_r_keys = {}
    for t in rem_r:
        rem_r_keys.setdefault(_stem_key(t), []).append(t)
    still_c = []
    for t in rem_c:
        lst = rem_r_keys.get(_stem_key(t))
        if lst:
            rem_r.remove(lst.pop())
            matched += 1
        else:
            still_c.append(t)
    # synonym stage over the leftovers: element-wise shared-synonym-group
    # tuple equivalence (the jar's WordNet-synset stage over the embedded
    # caption-domain table; one-to-one greedy)
    if synonyms:
        for t in still_c:
            for u in rem_r:
                if _tuples_match(t, u):
                    rem_r.remove(u)
                    matched += 1
                    break
    p = matched / len(cand)
    r = matched / len(ref)
    f = 0.0 if p + r == 0 else 2 * p * r / (p + r)
    return f, p, r


def spice_score(candidate: str, refs: Sequence[str], synonyms: bool = True) -> float:
    """Per-image SPICE F1 of the candidate against the union of the refs'
    scene-graph tuples (arXiv:1607.08822 eq. 5-7). synonyms=False disables
    the synonym tuple-matching stage (used to quantify its contribution)."""
    cand = parse_scene_graph(candidate).tuples()
    ref_tuples: set = set()
    for r in refs:
        ref_tuples |= parse_scene_graph(r).tuples()
    f, _, _ = _f1(cand, frozenset(ref_tuples), synonyms)
    return f


class NativeSpiceScorer:
    """Drop-in for SpiceScorer (evalcap/spice.py): compute(gts, res) ->
    (mean F, per-image array) on tokenized caption dicts."""

    def compute(
        self, gts: Dict[object, List[str]], res: Dict[object, List[str]]
    ) -> Tuple[float, np.ndarray]:
        img_ids = list(gts.keys())
        scores = np.asarray(
            [spice_score(res[i][0], gts[i]) for i in img_ids], dtype=np.float64
        )
        return float(scores.mean()) if len(scores) else 0.0, scores

    def close(self):  # protocol parity with the jar wrapper
        pass
