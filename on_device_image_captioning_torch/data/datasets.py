"""Dataset frontends: COCO-Karpathy and VizWiz.

A copy of the JAX package's `data/datasets.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

Rebuilds the reference's dataset layer behaviorally:
- COCO (reference data/coco_dataset.py:10-253): parses the Karpathy
  `dataset_coco.json`, routes 'train'+'restval' to train, builds the sorted
  min-occurrence-5 vocabulary from train captions (10k words for full COCO,
  PAD/SOS/EOS/UNK at 78/79/77/80);
- VizWiz (reference data/vizwiz_dataset.py:17-349): consolidates the annotation
  JSONs, drops images whose annotations contain the "Quality issues are too
  severe..." sentinel (strict mode drops the whole image), keeps per-image
  reference lists, truncates tokenized captions to max_seq_len, and can reuse the
  COCO vocabulary (reference :146-155).

Both expose the same record shape so the loader/eval layers are dataset-agnostic:
{'img_id', 'img_path', 'captions': [raw strings]}.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from .text import Vocab, tokenize

QUALITY_SENTINEL = "Quality issues are too severe to recognize visual content."

TRAIN, VAL, TEST = "train", "val", "test"


@dataclass
class CaptionDataset:
    """Split record lists + vocab; the common substrate for loaders and eval."""

    splits: Dict[str, List[dict]]
    vocab: Vocab
    max_seq_len: int  # longest SOS..EOS token sequence over train+val (+margin)
    image_root: str = ""

    def records(self, split: str) -> List[dict]:
        return self.splits[split]

    def num_images(self, split: str) -> int:
        return len(self.splits[split])


def _max_caption_len(records: List[dict]) -> int:
    longest = 0
    for r in records:
        for c in r["captions"]:
            longest = max(longest, len(tokenize(c)) + 2)  # + SOS/EOS
    return longest


def load_coco_karpathy(
    annotations_path: str,
    images_path: str = "",
    vocab: Optional[Vocab] = None,
    dict_min_occurrences: int = 5,
    limited: Optional[Dict[str, int]] = None,
    seq_len_margin: int = 20,
) -> CaptionDataset:
    """Parse the Karpathy split file (reference data/coco_dataset.py:67-125).

    `limited`: optional per-split truncation {'train': n, ...} (the reference's
    limited_num_*_images debug knobs). max_seq_len = longest train/val caption +
    margin, mirroring train.py:617's dataset-max + 20.
    """
    with open(annotations_path) as f:
        items = json.load(f)["images"]

    splits: Dict[str, List[dict]] = {TRAIN: [], VAL: [], TEST: []}
    for it in items:
        rec = {
            "img_id": it["cocoid"],
            "img_path": os.path.join(images_path, it["filepath"], "img", it["filename"]),
            "captions": [s["raw"] for s in it["sentences"]],
        }
        split = it["split"]
        if split in ("train", "restval"):
            splits[TRAIN].append(rec)
        elif split == "val":
            splits[VAL].append(rec)
        elif split == "test":
            splits[TEST].append(rec)

    if limited:
        for k, n in limited.items():
            splits[k] = splits[k][:n]

    if vocab is None:
        vocab = Vocab.build(
            (c for r in splits[TRAIN] for c in r["captions"]),
            min_occurrences=dict_min_occurrences,
        )
    max_len = (
        max(_max_caption_len(splits[TRAIN]), _max_caption_len(splits[VAL]))
        + seq_len_margin
    )
    return CaptionDataset(
        splits=splits, vocab=vocab, max_seq_len=max_len, image_root=images_path
    )


def _consolidate_vizwiz(annotation_json: dict, is_test: bool) -> Dict[int, dict]:
    """images + annotations lists -> {image_id: {image_path, annotations}}
    (reference data/vizwiz_dataset.py:255-270)."""
    out = {img["id"]: {"image_path": img["file_name"]} for img in annotation_json["images"]}
    if is_test:
        return out
    for ann in annotation_json["annotations"]:
        out[ann["image_id"]].setdefault("annotations", []).append(ann["caption"])
    return out


def load_vizwiz(
    annotations_dir: str,
    images_dir: str = "",
    vocab: Optional[Vocab] = None,
    dict_min_occurrences: int = 5,
    max_seq_len: int = 54,
    include_test: bool = False,
    strict_filter: bool = True,
) -> CaptionDataset:
    """Parse VizWiz train/val(/test) annotation JSONs
    (reference data/vizwiz_dataset.py:191-275).

    strict_filter drops any image that contains the quality sentinel among its
    captions; otherwise only the sentinel captions are removed. Images land under
    {images_dir}/{split}/{file_name} (reference data/vizwiz_dataloader.py:244-261).
    """
    splits: Dict[str, List[dict]] = {TRAIN: [], VAL: [], TEST: []}
    wanted = [TRAIN, VAL] + ([TEST] if include_test else [])
    for split in wanted:
        path = os.path.join(annotations_dir, f"{split}.json")
        with open(path) as f:
            raw = json.load(f)
        is_test = split == TEST
        consolidated = _consolidate_vizwiz(raw, is_test)
        for img_id, item in consolidated.items():
            if is_test:
                splits[split].append(
                    {
                        "img_id": img_id,
                        "img_path": os.path.join(images_dir, split, item["image_path"]),
                        "captions": [],
                    }
                )
                continue
            caps = item.get("annotations", [])
            if strict_filter and QUALITY_SENTINEL in caps:
                continue
            caps = [c for c in caps if c != QUALITY_SENTINEL]
            if not caps:
                continue
            splits[split].append(
                {
                    "img_id": img_id,
                    "img_path": os.path.join(images_dir, split, item["image_path"]),
                    "captions": caps,
                }
            )

    if vocab is None:
        vocab = Vocab.build(
            (c for r in splits[TRAIN] for c in r["captions"]),
            min_occurrences=dict_min_occurrences,
        )
    return CaptionDataset(
        splits=splits, vocab=vocab, max_seq_len=max_seq_len, image_root=images_dir
    )


def encode_caption_truncated(vocab: Vocab, caption: str, max_seq_len: int) -> List[int]:
    """SOS + tokens + EOS, truncated to max_seq_len keeping EOS last
    (reference data/vizwiz_dataset.py:79-101)."""
    ids = vocab.encode_caption(caption)
    if len(ids) > max_seq_len:
        ids = ids[: max_seq_len - 1] + [vocab.eos_idx]
    return ids
