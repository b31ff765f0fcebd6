"""Feature extraction over a dataset: the program's
`cli/generate_features.py::generate_features`, called on chunks of
`batches_per_call` batches of `batch` records until the window ends.

The records' images come from the benchmark's own `load_images`, which
hands out the seeded pool's rows; the store is in memory: it counts the rows
written and keeps the rows the check samples (no disk, no h5py). The
backbone is the serving configuration's, on its path and compute dtype;
the store's dtype is the traffic file's.

The check: the reference recomputes the backbone's features of
`check_rows` rows drawn from the seed among all those written in the window
(a reservoir: each row kept with the same chance whatever the window's
length; a call's draws are made at once, before it).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from .. import costs, program
from ..reference import checks
from ..traffic import gen


class _Store:
    """Counts the rows written and keeps a reservoir sample of `k` of them."""

    def __init__(self, k: int = 0, rng=None):
        self.k, self.rng, self.rows = k, rng, 0
        self.slots: List[int] = []  # the kept rows' ids, one a slot
        self.kept: Dict[int, torch.Tensor] = {}
        self.accept: Dict[int, int] = {}  # id -> slot, for the call to come

    def plan(self, first_id: int, n: int) -> None:
        """The reservoir's draws for the next n rows, ids first_id on (the
        rows this store has counted so far come before them)."""
        if not self.k:
            return
        pos = np.arange(self.rows, self.rows + n)
        slot = np.where(pos < self.k, pos, self.rng.integers(0, pos + 1))
        self.accept = {first_id + j: int(s) for j, s in enumerate(slot) if s < self.k}

    def write(self, img_id, features) -> None:
        self.rows += 1
        slot = self.accept.get(img_id)
        if slot is None:
            return
        if slot < len(self.slots):
            del self.kept[self.slots[slot]]
            self.slots[slot] = img_id
        else:
            self.slots.append(img_id)
        self.kept[img_id] = torch.from_numpy(np.array(features, copy=True))


class _Timed(nn.Module):
    """The backbone as `generate_features` calls it, inside a device span."""

    def __init__(self, swin, tracer):
        super().__init__()
        self.swin, self.tracer, self.cfg = swin, tracer, swin.cfg

    def forward(self, x, dtype=None):
        with self.tracer.device_span("backbone"):
            return self.swin(x, dtype)


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, tracer, quantize=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.tracer = torch.device(device), tracer
        self.quantize = quantize
        self.batch = traffic["batch"]

    def setup(self) -> None:
        from on_device_image_captioning_torch.cli.generate_features import generate_features

        t = self.traffic
        self.pool = gen.image_pool(t["pool_images"], self.cfg["swin"]["img_size"], self.seed,
                                   self.device, pin=self.device.type == "cuda")
        mcfg, model, weights = program.build_model(self.cfg, self.seed, self.device)
        self.shapes = [(n, tuple(w.shape)) for n, w in weights.items()]
        del weights
        if self.quantize:
            from on_device_image_captioning_torch.deploy.quantization import quantize_model
            quantize_model(model, self.quantize)
        swin = model.swin_transf.eval()
        swin.prepare_inference(mcfg.compute_dtype)
        self.swin, self.dtype = swin, mcfg.compute_dtype
        self.model = _Timed(swin, self.tracer) if self.tracer.enabled else swin
        self.generate = generate_features
        self.store_dtype = np.dtype(t["store_dtype"])
        self.next_id = 0
        self._call(_Store(), t["warmup_batches"])

    def _load_images(self, paths, size):
        """A batch of records -> its pool rows (record id i reads row i mod pool)."""
        first = int(paths[0])
        return gen.pool_batch(self.pool, len(paths), first // len(paths))

    def _call(self, store, batches: int) -> int:
        n = batches * self.batch
        records = [{"img_id": self.next_id + k, "img_path": str(self.next_id + k)}
                   for k in range(n)]
        self.next_id += n
        return self.generate(self.model, records, store, self.batch, self.dtype,
                             self.store_dtype, self._load_images, verbose=False)

    def window(self, seconds: float) -> Dict:
        t = self.traffic
        per_call = t["batches_per_call"] * self.batch
        self.store = _Store(t["check_rows"], gen.rng(self.seed, "check"))
        start = time.perf_counter()
        end = start + seconds
        calls = 0
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            self.tracer.iteration(calls, now - start, seconds)
            self.store.plan(self.next_id, per_call)
            self._call(self.store, t["batches_per_call"])
            calls += 1
        self.tracer.close()
        wall = time.perf_counter() - start
        return {"attempted": calls * per_call, "failed": calls * per_call - self.store.rows,
                "items": self.store.rows, "window_s": wall, "iters": calls}

    def end_to_end(self, res: Dict) -> Dict[str, tuple]:
        return {"features_per_s": (res["items"] / res["window_s"], "images/s")}

    def work(self, first: int, count: int) -> Dict[str, float]:
        """The frozen costs of `count` calls."""
        n = count * self.traffic["batches_per_call"]
        macs = costs.swin_macs(self.cfg["swin"])
        bound = costs.bound_s(costs.backbone_functions(self.cfg["swin"], self.batch))
        return {"items": n * self.batch, "macs": n * self.batch * macs, "bound_s": n * bound}

    def release(self) -> None:
        del self.swin, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, diag=None) -> List[tuple]:
        rows = self.store.kept
        if len(rows) < self.store.k:  # the window wrote fewer rows than the check samples
            return [("sampled_rows_missing", float(self.store.k - len(rows)), 0.0)]
        images = {i: self.pool[i % self.pool.shape[0]] for i in rows}
        return checks.features_numbers(self.cfg, self.shapes, self.seed, self.device, images,
                                       rows, self.traffic["limits"], diag)
