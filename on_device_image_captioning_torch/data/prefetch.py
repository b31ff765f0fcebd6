"""Background batch prefetching.

A copy of the JAX package's `data/prefetch.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

The reference materializes each batch synchronously on the training thread
(PIL decode / h5py reads inside the hot loop — reference
data/coco_dataloader.py:213-342). This helper overlaps host-side batch
materialization with device compute: a worker thread keeps a small queue of
ready batches ahead of the consumer, so the device never waits on JPEG decode.

Works with any loader exposing get_next_batch(); the materialize function maps
the raw batch dict to device-ready arrays (run in the worker thread)."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class PrefetchIterator:
    def __init__(
        self,
        next_batch: Callable[[], dict],
        materialize: Callable[[dict], dict],
        depth: int = 2,
        snapshot: Optional[Callable[[], dict]] = None,
    ):
        """snapshot: called in the worker right after each next_batch() (e.g.
        loader.save_state). `consumed_state` then always holds the cursor as of
        the last batch the CONSUMER took, even though the worker's loader runs
        up to `depth` batches ahead — so checkpoints resume at the exact next
        batch (reference data/transparent_data_loader.py:49-61 semantics)."""
        self._next_batch = next_batch
        self._materialize = materialize
        self._snapshot = snapshot
        self.consumed_state: Optional[dict] = snapshot() if snapshot else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._next_batch()
                state = self._snapshot() if self._snapshot else None
                arrays = self._materialize(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put((batch, arrays, state), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._error = e

    def get(self, timeout: float = 300.0):
        """Next (raw_batch, materialized) pair; raises the worker's error if it
        died. Batches already queued before the worker died (e.g. the producer
        raising StopIteration at end of a finite stream) are drained FIRST, so
        no produced batch is ever dropped."""
        while True:
            try:
                batch, arrays, state = self._q.get_nowait()
                if state is not None:
                    self.consumed_state = state
                return batch, arrays
            except queue.Empty:
                pass
            if self._error is not None:
                raise self._error
            try:
                batch, arrays, state = self._q.get(timeout=0.5)
                if state is not None:
                    self.consumed_state = state
                return batch, arrays
            except queue.Empty:
                timeout -= 0.5
                if timeout <= 0:
                    raise TimeoutError("prefetch worker stalled")

    def close(self):
        self._stop.set()
        # drain so the worker unblocks from a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __iter__(self) -> Iterator:
        while True:
            yield self.get()
