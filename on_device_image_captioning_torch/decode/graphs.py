"""CUDA graphs over the early-exit beam search
(`decode/beam_search.py::ensemble_beam_search`): when they engage, what
keys them, and the graphs themselves.

On the card a beam-search step is about 180 small launches, and the host,
not the card, sets their pace. So the beam search captures each of its
steps once into a CUDA graph and then replays it: one launch a step in
place of the step's kernels one by one. Every kernel still runs, in the
same order, on the same operands, at the same precision.

- When (`engages`): CUDA encoder outputs, `sample_or_max == "max"`, no
  generator and no noise, gradients off, outside
  `torch.compiler.is_compiling()`, and no model cut over a model axis (the
  cut layers' collectives are not captured). Every other call runs the
  eager loop.
- The key (`decode_key`): the models, the encoder outputs' shapes, dtypes
  and device, the pads' (or none), the decode configuration with its checked
  chunk schedule, the compute dtype (the caches'), the step path, inference
  mode, the matmul precision flags and the calling thread (a thread replays
  only its own graphs: their inputs and outputs are fixed buffers). The
  weights (`weights_state`): the address and version of every parameter and
  buffer on the decoder side, as `decode/cache.py::_cross_operands` keys its
  layouts.
- A key's life (`DecodeCache`): its first call runs eagerly, which loads
  the kernels, sizes the kernel workspaces, creates the cuBLAS handles and
  lays out the fused step's operands; its second captures every step, then
  replays; later calls replay. A key whose weights moved is dropped with
  its graphs, and its next call warms up anew. At most `CAPACITY` keys are
  kept, the least recently used dropped first; a key seen once holds no
  graph.
- A graph (`CudaGraph`) is captured on a side stream of the device and the
  thread, into the memory pool that the graphs of one decode share, and
  replays on the current stream. The counts made while it is captured (the
  weight casts of `models/common.py::linear`) are set aside and added back
  at each replay, with one `decode_graph_replay`; a capture counts
  `decode_graph_capture`. So are the decode kernels' launch counters
  (`LAUNCH_COUNTERS`), which the kernels' Python wrappers raise as they
  launch: a replay launches the same kernels.
  `HostGraph` keeps the same contract without a card: its replay runs the
  step again and copies what it returns into the captured outputs, which is
  how the CPU tests run the graphed loop.
- What a graph reads outside its pool stays alive: the captured decode holds
  the kernel workspaces, the layouts and the weights (`lazy_state`,
  `decoder_tensors`). A capture that had to size or lay out anything
  (`lazy_state` changed) is thrown away and the call runs eagerly.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..ops import dyn_exp_step, layernorm, quant_matmul, topk
from ..utils.profiling import count, set_aside
from . import cache as dc

CAPACITY = 4  # keys a cache keeps, warmed or captured
# the modules of a captioner that its decode reads
DECODER_SIDE = ("decoders", "out_embedder", "pos_encoder", "dec_reduce_group",
                "dec_reduce_norm", "vocab_linear")
# (module, attribute) of the launch counter of each kernel a decode step runs
LAUNCH_COUNTERS = ((dyn_exp_step, "launches"), (dyn_exp_step, "cross_launches"),
                   (topk, "launches"), (layernorm, "launches"),
                   (quant_matmul, "launches"), (quant_matmul, "quantize_launches"))


def engages(models: Sequence, enc_outputs: Sequence[torch.Tensor], decode_cfg,
            generator: Optional[torch.Generator], noise) -> bool:
    """Whether `ensemble_beam_search` replays graphs for this call (see the
    module docstring)."""
    return (decode_cfg.sample_or_max == "max" and generator is None and noise is None
            and all(e.is_cuda for e in enc_outputs) and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not any(getattr(m, "model_axis_cuts", None) for m in models))


def decode_key(models: Sequence, enc_outputs: Sequence[torch.Tensor], decode_cfg,
               chunks: Tuple[int, ...], dtype: Optional[torch.dtype],
               enc_num_pads: Optional[torch.Tensor], step_impl: str) -> tuple:
    """What a decode's graphs bake in, apart from the weights."""
    pads = None if enc_num_pads is None else (
        tuple(enc_num_pads.shape), enc_num_pads.dtype, enc_num_pads.device)
    matmul = torch.backends.cuda.matmul
    return (tuple(id(m) for m in models),
            tuple((tuple(e.shape), e.dtype, e.device) for e in enc_outputs), pads,
            decode_cfg.beam_size, decode_cfg.how_many_outputs, decode_cfg.max_seq_len,
            decode_cfg.sos_idx, decode_cfg.eos_idx, chunks, dtype, step_impl,
            torch.is_inference_mode_enabled(), matmul.allow_tf32,
            matmul.allow_bf16_reduced_precision_reduction, threading.get_ident())


def decoder_tensors(model) -> List[torch.Tensor]:
    """The parameters and buffers of the model's decoder side."""
    mods = [getattr(model, name) for name in DECODER_SIDE]
    return [t for mod in mods for t in (*mod.parameters(), *mod.buffers())]


def weights_state(models: Sequence) -> tuple:
    """Each decoder-side tensor's (address, version), model by model."""
    return tuple(tuple(map(dc.tensor_state, decoder_tensors(m))) for m in models)


def lazy_state(models: Sequence, device: torch.device) -> tuple:
    """What a decode sizes or lays out at first use and keeps: the step and
    int8 kernels' workspaces on `device`, and each decoder layer's
    `_cross_operands` (None where not made yet)."""
    return (dyn_exp_step._workspace.get(device), quant_matmul._workspace.get(device),
            *(getattr(layer, "_cross_operands", None) for m in models for layer in m.decoders))


def same_lazy_state(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def restore_lazy_state(models: Sequence, device: torch.device, state: tuple) -> None:
    """Put back what `lazy_state` returned: a capture that sized or laid out
    anything left its new objects in the graphs' pool, which no eager call
    may read."""
    for store, value in zip((dyn_exp_step._workspace, quant_matmul._workspace), state):
        if value is None:
            store.pop(device, None)
        else:
            store[device] = value
    layers = [layer for m in models for layer in m.decoders]
    for layer, value in zip(layers, state[2:]):
        if value is None:
            layer.__dict__.pop("_cross_operands", None)
        else:
            layer._cross_operands = value


def tensors(obj) -> Iterator[torch.Tensor]:
    """The tensors of nested lists, tuples and dataclasses, in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from tensors(item)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))


def _launched() -> List[int]:
    return [getattr(mod, name) for mod, name in LAUNCH_COUNTERS]


def _set_back(before: Sequence[int]) -> List[int]:
    """Put the launch counters back to `before`; returns what each gained
    since (a capture launches nothing: its replays count the launches)."""
    gained = []
    for (mod, name), n in zip(LAUNCH_COUNTERS, before):
        gained.append(getattr(mod, name) - n)
        setattr(mod, name, n)
    return gained


def _replayed(counts: Dict[str, int], launched: Sequence[int]) -> None:
    count("decode_graph_replay")
    for name, n in counts.items():
        count(name, n)
    for (mod, name), n in zip(LAUNCH_COUNTERS, launched):
        setattr(mod, name, getattr(mod, name) + n)


class CudaGraph:
    """One step captured into a CUDA graph: `capture(fn)` records fn's
    launches on `stream` into `pool` and returns fn's outputs, which each
    `replay()` overwrites in place."""

    def __init__(self, pool, stream: torch.cuda.Stream):
        self.pool, self.stream = pool, stream
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable):
        before = _launched()
        with set_aside() as counts, torch.cuda.stream(self.stream):
            self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:  # end the broken capture; fn's own error is the one to raise
                    self.graph.capture_end()
                except Exception:
                    pass
                raise
            self.graph.capture_end()
        self.counts, self.launched = dict(counts), _set_back(before)
        count("decode_graph_capture")
        return out

    def replay(self) -> None:
        self.graph.replay()
        _replayed(self.counts, self.launched)


class HostGraph:
    """`CudaGraph`'s contract without a card: the capture runs fn, and a
    replay runs it again and copies its outputs into the captured ones
    (outputs that are the captured tensors themselves are left as they are).
    Right where fn reads nothing but its captured inputs, as the beam
    search's steps do."""

    def capture(self, fn: Callable):
        before = _launched()
        with set_aside() as counts:
            out = fn()
        self.fn, self.out = fn, out
        self.counts, self.launched = dict(counts), _set_back(before)
        count("decode_graph_capture")
        return out

    def replay(self) -> None:
        before = _launched()
        with set_aside():
            fresh = self.fn()
        _set_back(before)
        for static, new in zip(tensors(self.out), tensors(fresh), strict=True):
            if static is not new:
                static.copy_(new)
        _replayed(self.counts, self.launched)


_streams: Dict[tuple, torch.cuda.Stream] = {}  # (device, thread) -> its capture stream


def cuda_graphs(device: torch.device) -> Callable[[], CudaGraph]:
    """A maker of one decode's graphs: a new memory pool they share, and the
    side stream of the device and the calling thread that they capture on."""
    key = (device, threading.get_ident())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(device)
    pool = torch.cuda.graph_pool_handle()
    return lambda: CudaGraph(pool, stream)


def host_graphs(device: torch.device) -> Callable[[], HostGraph]:
    return HostGraph


@dataclasses.dataclass
class Entry:
    models: Tuple[weakref.ref, ...]
    weights: tuple  # `weights_state` after the warm-up
    decode: Optional[object] = None  # the captured decode, once the second call made it


class DecodeCache:
    """The keys seen, least recently used first, each with its captured
    decode once it has one."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.entries: "collections.OrderedDict[tuple, Entry]" = collections.OrderedDict()
        self._lock = threading.Lock()  # threads share the cache, not its entries

    def lookup(self, key: tuple, models: Sequence) -> Optional[Entry]:
        """The entry of `key` if a call with these models and weights warmed
        it up, else None: the call is then a warm-up (an entry whose models
        are gone or whose weights moved is dropped first)."""
        weights = weights_state(models)
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                return None
            if (any(ref() is not m for ref, m in zip(entry.models, models))
                    or entry.weights != weights):
                del self.entries[key]
                return None
            self.entries.move_to_end(key)
            return entry

    def warmed(self, key: tuple, models: Sequence) -> Entry:
        """Note that `key` was warmed up with these models, their weights as
        they are now; the least recently used keys beyond the capacity go."""
        entry = Entry(tuple(weakref.ref(m) for m in models), weights_state(models))
        with self._lock:
            self.entries[key] = entry
            self.entries.move_to_end(key)
            while len(self.entries) > self.capacity:
                self.entries.popitem(last=False)
        return entry
