"""Resumable, deterministically rank-sharded batch loader (a copy of the JAX
package's `data/loader.py`, which rebuilds the reference's
TransparentDataLoader + CocoDataLoader scheme, reference
data/transparent_data_loader.py:6-77, data/coco_dataloader.py:85-212):

- every rank runs the identical seeded shuffle (one seed per epoch from
  `array_of_init_seeds`) and takes its own column of a round-robin
  assignment, so shard contents are reproducible on any host without
  communication (reference data/vizwiz_dataloader.py:318-360);
- `batch_size` is the GLOBAL batch: each rank receives batch_size //
  num_procs rows per step (reference data/coco_dataloader.py:141-156);
- the loader IS the training cursor: save_state()/load_state() carry
  {batch_it, epoch_it, batch_size, seeds} so a restart resumes mid-epoch at
  the exact batch (reference data/transparent_data_loader.py:49-61);
- 'caption_wise' mode yields one (image, caption) pair per row (XE);
  'image_wise' yields one image with all its references (SCST)
  (reference data/coco_dataloader.py:111-194).

The loader stays on the host and knows no framework: it yields record
indices and encoded captions; features, image decode and the copy to the
card belong to the consumer (`cli/train.py`).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

from .datasets import TRAIN, CaptionDataset, encode_caption_truncated
from .text import pad_batch


class ShardedCaptionLoader:
    NOT_DEFINED = -1

    def __init__(
        self,
        dataset: CaptionDataset,
        array_of_init_seeds: Sequence[int],
        batch_size: int,
        rank: int = 0,
        num_procs: int = 1,
        mode: str = "caption_wise",
        split: str = TRAIN,
    ):
        assert mode in ("caption_wise", "image_wise")
        self.dataset = dataset
        self.mode = mode
        self.split = split
        self.rank = rank
        self.num_procs = num_procs
        self.batch_size = batch_size
        # the reference multiplies the seed list x10 to allow extra epochs
        # (data/coco_dataloader.py:49-50)
        self.array_of_init_seeds = list(array_of_init_seeds) * 10
        self.max_num_epoch = len(array_of_init_seeds)
        self.epoch_it = 0
        self.batch_it = 0
        self.num_batches = self.NOT_DEFINED
        self._schedule: List[List[dict]] = []
        self.set_epoch_it(0)

    # -- schedule construction ------------------------------------------------

    def _epoch_items(self, rng: random.Random) -> List:
        records = self.dataset.records(self.split)
        if self.mode == "caption_wise":
            items = [
                (i, j)
                for i, r in enumerate(records)
                for j in range(len(r["captions"]))
            ]
        else:
            items = list(range(len(records)))
        rng.shuffle(items)
        return items

    def init_epoch(self, epoch_it: int, verbose: bool = False) -> None:
        rng = random.Random(self.array_of_init_seeds[epoch_it])
        items = self._epoch_items(rng)

        global_bs = self.batch_size
        per_rank = max(global_bs // self.num_procs, 1)
        # drop the tail that does not fill a full global batch
        # (reference data/coco_dataloader.py:129-135)
        usable = len(items) - len(items) % (global_bs * self.num_procs)
        items = items[:usable]

        # round-robin: element i goes to rank i % num_procs
        mine = items[self.rank :: self.num_procs]
        self.num_batches = len(mine) // per_rank if per_rank else 0
        self._schedule = [
            mine[b * per_rank : (b + 1) * per_rank] for b in range(self.num_batches)
        ]
        self.batch_it = 0

    # -- TransparentDataLoader cursor API ------------------------------------

    def set_epoch_it(self, epoch: int, verbose: bool = False) -> None:
        assert epoch < len(self.array_of_init_seeds), "epoch beyond seed list"
        self.epoch_it = epoch
        self.init_epoch(epoch, verbose)

    def get_epoch_it(self) -> int:
        return self.epoch_it

    def get_num_epoch(self) -> int:
        return self.max_num_epoch

    def get_num_batches(self) -> int:
        return self.num_batches

    def set_batch_it(self, batch_it: int) -> None:
        self.batch_it = batch_it

    def get_batch_it(self) -> int:
        return self.batch_it

    def get_batch_size(self) -> int:
        return self.batch_size

    def change_batch_size(self, batch_size: int, verbose: bool = False) -> None:
        self.batch_size = batch_size
        self.set_epoch_it(0, verbose)
        self.batch_it = 0

    def save_state(self) -> Dict:
        return {
            "batch_it": self.batch_it,
            "epoch_it": self.epoch_it,
            "batch_size": self.batch_size,
            "array_of_init_seed": self.array_of_init_seeds,
        }

    def load_state(self, state: Dict) -> None:
        self.array_of_init_seeds = list(state["array_of_init_seed"])
        self.batch_size = state["batch_size"]
        self.set_epoch_it(state["epoch_it"])
        self.batch_it = state["batch_it"]

    # -- batch access ---------------------------------------------------------

    def get_next_batch(self, max_seq_len: Optional[int] = None) -> Dict:
        """Advance the cursor; rolls to the next epoch when exhausted.

        caption_wise -> {'img_idxs', 'captions' (padded idx lists), 'num_pads'}
        image_wise   -> {'img_idxs', 'all_captions' (raw strings per image)}
        """
        if self.batch_it >= self.num_batches:
            self.set_epoch_it(self.epoch_it + 1)
        batch = self._schedule[self.batch_it]
        self.batch_it += 1
        return self.materialize(batch, max_seq_len)

    def materialize(self, batch, max_seq_len: Optional[int] = None) -> Dict:
        vocab = self.dataset.vocab
        records = self.dataset.records(self.split)
        limit = max_seq_len or self.dataset.max_seq_len
        if self.mode == "caption_wise":
            img_idxs = [i for i, _ in batch]
            caps = [
                encode_caption_truncated(vocab, records[i]["captions"][j], limit)
                for i, j in batch
            ]
            padded, num_pads = pad_batch(caps, vocab.pad_idx)
            return {"img_idxs": img_idxs, "captions": padded, "num_pads": num_pads}
        img_idxs = list(batch)
        return {
            "img_idxs": img_idxs,
            "all_captions": [records[i]["captions"] for i in img_idxs],
        }

    def image_paths(self, img_idxs: Sequence[int]) -> List[str]:
        records = self.dataset.records(self.split)
        return [records[i]["img_path"] for i in img_idxs]

    def image_ids(self, img_idxs: Sequence[int]) -> List[int]:
        records = self.dataset.records(self.split)
        return [records[i]["img_id"] for i in img_idxs]
