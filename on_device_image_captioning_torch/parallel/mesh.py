"""Data parallelism over `torch.distributed` (counterpart of the JAX
package's `parallel/mesh.py`, whose SPMD mesh becomes one process per card).

The reference's only parallelism is single-node data parallelism: one
process per GPU, DDP's gradient all-reduce, and rank-sharded batching in the
dataloader (reference train.py:357-450, data/coco_dataloader.py:139-163).
Here, as there:

- `init_distributed` joins the process group the launcher describes in the
  environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; torchrun sets
  them, as does any launcher that exports them): NCCL on the card, gloo on
  the CPU. A process on the card takes card LOCAL_RANK (else its rank modulo
  the cards it sees);
- `DataParallel` wraps the model in `DistributedDataParallel`. Its weights
  start equal on every rank (the same seed or checkpoint on each, and DDP
  broadcasts rank 0's at construction, as the JAX `_put` assembles them from
  process-local copies);
- each rank materializes only its own loader rows (`data/loader.py`), so a
  batch needs no placement but the copy to the rank's device, and the JAX
  `shard_batch`, `local_rows` and `host_copy` have no counterpart: the rows
  are rank-local and the weights and optimizer state whole on every rank.
  Rank 0 writes checkpoints; the others wait at `barrier`.

A training step runs its whole differentiable computation as ONE forward of
the wrapped module (`DataParallel.__call__`), so DDP sees one forward per
backward even where the step calls the encoder and the decoder apart (the
SCST steps). The XE loss of a rank is divided by the non-pad tokens of ALL
ranks (`DataParallel.sum`) and multiplied by the world size: DDP's average
of the gradients then equals the gradient of the whole batch's loss, as the
JAX step's single reduction over the sharded batch gives it.

Serving, evaluation and training also take a model axis (the JAX package's
`make_mesh(n_data, n_model)` and `_MODEL_AXIS_RULES`): `make_grid` cuts a
world of W processes into `W / n_model` data ranks by `n_model` model ranks,
each model group consecutive ranks; `shard_model` replaces every layer the
rule table (`MODEL_AXIS_RULES`, the JAX rules in the reference's parameter
names) matches by its rank's slice (`parallel/tensor.py`), so a model group
runs one model and meets only inside itself. The collectives over the whole
world are `gather_predictions` (per-image predictions to rank 0, the
counterpart of `local_rows` / `host_copy` for evaluation) and the sums of
`all_reduce_sum`. Int8 layers (`deploy/quantization.py::QuantLinear`) stay
whole on every rank, as the JAX rules match no `w_q` or `scale` leaf.

Training over the grid (the JAX `shard_train_state` and `host_copy`):
`shard_model` records how it cut each parameter (`Cut`); the optimizer's
moments and gradient accumulators are cut the same way
(`cut_optimizer_state`), counters and replicated leaves stay whole;
`gather_state_dict` and `gather_optimizer_state` put the whole state back
together on every rank of a model group (a checkpoint loads at any
`--n_model`); `DataParallel` runs DDP over the data group only, so a model
group's ranks, which read the same rows, are counted once.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .tensor import ShardedEmbedding, ShardedLinear


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def init_distributed(device: torch.device) -> torch.device:
    """Join the process group of the launcher's environment (NCCL for a
    card, gloo for the CPU); returns this rank's device."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs {missing} in the environment (the launcher's)")
    if device.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", int(os.environ["RANK"])
                                   % torch.cuda.device_count()))
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if not is_distributed():
        cuda = device.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                                device_id=device if cuda else None)
    return device


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


# module-name regex -> how the layer is cut over the model axis: the JAX
# package's _MODEL_AXIS_RULES (parallel/mesh.py there) on this package's, i.e.
# the reference's, names. nn.Linear.weight is (out, in): JAX's P(None, "model")
# on a (in, out) w is a slice of weight's rows and of the bias ("column"),
# P("model", None) a slice of weight's columns with the bias whole ("row").
# "heads" is a column slice of Swin's qkv taken by heads (the rank's heads of
# each of q, k, v, and the same heads of the relative-position bias table),
# where JAX cuts the 3C columns contiguously: the port's own layout, equal in
# results. "vocab" is a column slice assembled into whole rows; "embedding"
# the rank's rows of the table (JAX's P("model", None) on embed).
MODEL_AXIS_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(^|\.)ff\.linear_1$", "column"),
    (r"(^|\.)ff\.linear_2$", "row"),
    (r"(^|\.)mlp\.fc1$", "column"),
    (r"(^|\.)mlp\.fc2$", "row"),
    (r"(^|\.)attn\.qkv$", "heads"),
    (r"(^|\.)attn\.proj$", "row"),
    (r"(^|\.)vocab_linear$", "vocab"),
    (r"(^|\.)out_embedder\.embed$", "embedding"),
)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid: `n_data` x `n_model`
    ranks, model groups of consecutive ranks. A group of one rank is None
    (no collective); a group is the world's default group where it spans
    the world."""

    n_data: int = 1
    n_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None


def make_grid(n_model: int = 1) -> Grid:
    """The grid of the joined process group (the counterpart of the JAX
    `make_mesh(W / n_model, n_model)`); a process without a group is a grid
    of one. Every rank calls it (it makes every group, in one order)."""
    world = process_count()
    if n_model < 1:
        raise SystemExit(f"--n_model {n_model}: the model axis takes 1 or more ranks")
    if n_model > 1 and not is_distributed():
        raise SystemExit(f"--n_model {n_model} needs --distributed: one process a card, "
                         "n_model processes a model group")
    if world % n_model:
        raise SystemExit(f"--n_model {n_model} does not divide the world of {world} "
                         "processes (one a card)")
    rank, n_data = process_index(), world // n_model

    def group_of(groups: List[List[int]]):
        mine = None
        for ranks in groups:  # every rank makes every group, in the same order
            if len(ranks) == world:
                return dist.group.WORLD
            if len(ranks) == 1:
                continue
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    model_group = group_of([list(range(d * n_model, (d + 1) * n_model)) for d in range(n_data)])
    data_group = group_of([list(range(m, world, n_model)) for m in range(n_model)])
    return Grid(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group)


@dataclasses.dataclass(frozen=True)
class Cut:
    """How a parameter is cut over the model axis: the rank holds the whole
    tensor's entries at `index` along `dim`; `whole` is the whole shape."""

    dim: int
    index: torch.Tensor
    whole: Tuple[int, ...]

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's part of a whole tensor."""
        return t.index_select(self.dim, self.index.to(t.device))

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """A whole-shaped buffer of negative zeros with the rank's part `t`
        written in. The sum of the group's buffers is the whole tensor, bit
        for bit: every other term is -0.0, which adds exactly to anything,
        +0.0 included (a +0.0 fill would turn a -0.0 into +0.0)."""
        buf = torch.full(self.whole, -0.0, dtype=t.dtype, device=t.device)
        return buf.index_copy_(self.dim, self.index.to(t.device), t)

    def gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """The whole tensor from the group's parts (`place`, summed over the
        group). A collective: every rank of the group calls it."""
        buf = self.place(t)
        dist.all_reduce(buf, group=group)
        return buf


def model_axis_layers(model: nn.Module) -> List[Tuple[str, str, str]]:
    """(module name, kind, rule) of every layer the rules cut, in module
    order. A "fused" backbone's layers are left out: its block kernels take
    whole weights and carry the residual in their epilogues (ROADMAP B-15),
    so they stay whole on every rank; the rules hold on "pallas"."""
    from ..models.swin import SwinTransformer

    whole = [name + "." for name, m in model.named_modules()
             if isinstance(m, SwinTransformer) and m.cfg.attention_impl != "pallas"]
    out = []
    for name, mod in model.named_modules():
        if not isinstance(mod, (nn.Linear, nn.Embedding)) or any(map(name.startswith, whole)):
            continue
        for pattern, kind in MODEL_AXIS_RULES:
            if re.search(pattern, name):
                out.append((name, kind, pattern))
                break
    return out


def _layer_cuts(model: nn.Module, name: str, kind: str, n: int, r: int) -> Dict[str, Cut]:
    """{parameter name: Cut} of one layer the rules cut, on this rank."""
    mod = model.get_submodule(name)
    w = mod.weight
    out_dim, in_dim = w.shape[0], w.shape[-1]

    def span(count: int) -> torch.Tensor:
        return torch.arange(r * (count // n), (r + 1) * (count // n))

    if kind == "embedding":
        return {name + ".weight": Cut(0, span(out_dim), tuple(w.shape))}
    if kind == "row":
        return {name + ".weight": Cut(1, span(in_dim), tuple(w.shape))}
    if kind == "heads":
        owner_name = name.rpartition(".")[0]
        owner = model.get_submodule(owner_name)
        c, local = out_dim // 3, owner.heads // n
        width = local * (c // owner.heads)
        rows = torch.cat([torch.arange(t * c + r * width, t * c + (r + 1) * width)
                          for t in range(3)])
        table = owner.relative_position_bias_table
        cuts = {name + ".weight": Cut(0, rows, tuple(w.shape)),
                owner_name + ".relative_position_bias_table":
                    Cut(1, torch.arange(r * local, (r + 1) * local), tuple(table.shape))}
    else:
        rows = span(out_dim)
        cuts = {name + ".weight": Cut(0, rows, tuple(w.shape))}
    if getattr(mod, "bias", None) is not None:
        cuts[name + ".bias"] = Cut(0, rows, tuple(mod.bias.shape))
    return cuts


def shard_model(model: nn.Module, grid: Grid) -> List[str]:
    """Replace every layer `model_axis_layers` names by this rank's slice
    (the counterpart of the JAX `shard_params`), in place; the model stays
    on its device and its weights keep their `requires_grad` (a model cut
    for training trains its slices). Call it on the loaded weights, before
    `prepare_inference` (which expands the sliced bias tables) and before
    an optimizer is built on the parameters. Records how each parameter was
    cut in `model.model_axis_cuts` ({name: Cut}; `gather_state_dict`,
    `cut_optimizer_state` and `gather_optimizer_state` read it). Returns the
    lines that say which rule cut which layers, which layers the rules name
    but stay whole, and the bytes of weights a rank holds. A width the axis
    does not divide raises, naming the layer (the port does not pad)."""
    from ..deploy.quantization import QuantLinear

    n, r = grid.n_model, grid.model_rank
    if n == 1:
        return []
    layers = model_axis_layers(model)
    for name, kind, _ in layers:  # every width first: no half-sharded model
        mod = model.get_submodule(name)
        if kind == "heads":
            owner = model.get_submodule(name.rpartition(".")[0])
            width, what = owner.heads, "heads"
        elif kind == "row":
            width, what = mod.in_features, "input features"
        elif kind == "embedding":
            width, what = mod.num_embeddings, "rows (the vocabulary)"
        else:
            width, what = mod.out_features, "output features"
        if width % n:
            raise SystemExit(f"--n_model {n} does not divide {name}'s {width} {what} "
                             "(the port does not pad)")
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    int8 = [name for name, mod in model.named_modules() if isinstance(mod, QuantLinear)
            and any(re.search(pattern, name) for pattern, _ in MODEL_AXIS_RULES)]
    group = grid.model_group
    by_rule: Dict[str, List[str]] = {}
    cuts: Dict[str, Cut] = {}
    for name, kind, pattern in layers:
        mod = model.get_submodule(name)
        by_rule.setdefault(f"{pattern} ({kind})", []).append(name)
        layer_cuts = _layer_cuts(model, name, kind, n, r)
        cuts.update(layer_cuts)
        grad = mod.weight.requires_grad
        w = layer_cuts[name + ".weight"].take(mod.weight.detach())
        b = getattr(mod, "bias", None)
        if b is not None and name + ".bias" in layer_cuts:
            b = layer_cuts[name + ".bias"].take(b.detach())
        if kind == "embedding":
            new = ShardedEmbedding(w, r * w.shape[0], mod.num_embeddings, group, grad)
        elif kind == "row":
            new = ShardedLinear("row", w, b, group, requires_grad=grad)
        elif kind == "heads":
            new = ShardedLinear("column", w, b, group, requires_grad=grad)
            owner_name = name.rpartition(".")[0]
            owner = model.get_submodule(owner_name)
            table = owner.relative_position_bias_table
            owner.relative_position_bias_table = nn.Parameter(
                cuts[owner_name + ".relative_position_bias_table"].take(table.detach()),
                requires_grad=table.requires_grad)
            owner.head_cut = (r * (owner.heads // n), owner.heads)
            owner.heads, owner.rel_bias_x = owner.heads // n, None
        else:
            new = ShardedLinear("vocab" if kind == "vocab" else "column", w, b, group,
                                r * w.shape[0], mod.out_features, grad)
        model.set_submodule(name, new)
    model.model_axis_cuts = cuts
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    lines = [f"model axis: {n} ranks a model group, {grid.n_data} data ranks"]
    lines += [f"  {rule}: {len(names)} layers ({names[0]}{', ...' if len(names) > 1 else ''})"
              for rule, names in by_rule.items()]
    if int8:
        lines.append(f"  whole on every rank: {len(int8)} int8 layers the rules name "
                     f"({int8[0]}{', ...' if len(int8) > 1 else ''}): the JAX rules match no "
                     "w_q or scale leaf")
    lines.append(f"  weights a rank holds: {held} bytes of {whole} whole")
    return lines


def gather_state_dict(model: nn.Module, grid: Grid) -> Dict[str, torch.Tensor]:
    """The whole model's state_dict, in the reference's names, from a model
    cut by `shard_model` (its own state_dict where nothing is cut). Every
    rank of the model group calls it and gets the whole."""
    sd = model.state_dict()
    cuts = getattr(model, "model_axis_cuts", None)
    if not cuts:
        return sd
    return {k: cuts[k].gather(v, grid.model_group) if k in cuts else v for k, v in sd.items()}


def _map_param_state(state, fn):
    """An optimizer's state_dict with fn(i, tensor) applied to every tensor
    held for parameter i: the moments of a torch optimizer's "state" (and
    of the wrappers' nested "optimizer": `train/schedules.py::Scheduled`,
    `train/train_step.py::_EveryK`) and `_EveryK`'s summed gradients. Every
    other entry (counts, param_groups) is kept as it is."""
    if not isinstance(state, dict):
        return state
    out = dict(state)
    if "optimizer" in out:
        out["optimizer"] = _map_param_state(out["optimizer"], fn)
    if isinstance(out.get("grads"), list):
        out["grads"] = [None if g is None else fn(i, g) for i, g in enumerate(out["grads"])]
    if "state" in out and "param_groups" in out:
        out["state"] = {i: {k: fn(i, v) if torch.is_tensor(v) else v for k, v in st.items()}
                        for i, st in out["state"].items()}
    return out


def _param_cuts(model: nn.Module) -> List[Optional[Cut]]:
    """The Cut of each parameter in `model.parameters()` order (the order an
    optimizer built on them numbers them), None where it is whole."""
    cuts = getattr(model, "model_axis_cuts", None) or {}
    return [cuts.get(name) for name, _ in model.named_parameters()]


def cut_optimizer_state(state: dict, model: nn.Module) -> dict:
    """A whole optimizer state_dict (of an optimizer on the whole model's
    parameters, in order) cut for an optimizer on the parameters of
    `model` after `shard_model`: every tensor of a cut parameter's shape
    is cut as the parameter (the JAX `shard_train_state`'s moments on their
    weights' specs); scalars and replicated leaves stay whole."""
    cuts = _param_cuts(model)

    def cut(i, t):
        c = cuts[i]
        return c.take(t) if c is not None and tuple(t.shape) == c.whole else t

    return _map_param_state(state, cut)


def gather_optimizer_state(state: dict, model: nn.Module, grid: Grid) -> dict:
    """The whole optimizer state_dict from a rank's (the counterpart of the
    JAX `host_copy` of the train state): a collective over the model
    group, every rank gets the whole."""
    cuts = _param_cuts(model)
    shapes = [tuple(p.shape) for p in model.parameters()]
    if not any(cuts):
        return state

    def whole(i, t):
        c = cuts[i]
        if c is None or tuple(t.shape) != shapes[i]:
            return t
        return c.gather(t, grid.model_group)

    return _map_param_state(state, whole)


def optimizer_state_bytes(state: dict, model: nn.Module) -> Tuple[int, int]:
    """(bytes a rank holds, bytes of the whole state) of the per-parameter
    tensors of an optimizer state_dict."""
    cuts = _param_cuts(model)
    held, whole = [0], [0]

    def count(i, t):
        c = cuts[i]
        held[0] += t.numel() * t.element_size()
        n = int(np.prod(c.whole)) if c is not None and t.dim() == len(c.whole) else t.numel()
        whole[0] += n * t.element_size()
        return t

    _map_param_state(state, count)
    return held[0], whole[0]


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` (a copy; x itself where the group is None)."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def gather_predictions(predictions: Dict) -> Dict:
    """Every rank's {image id: prediction} merged on rank 0 (a model group's
    ranks hold the same ones); {} on the other ranks."""
    parts = [None] * process_count() if process_index() == 0 else None
    dist.gather_object(predictions, parts, dst=0)
    merged = {}
    for part in parts or []:
        merged.update(part)
    return merged


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether `flag` holds on any rank: every rank takes the same branch
    around a collective (a checkpoint save decided by each rank's clock)."""
    if not is_distributed():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class _Apply(nn.Module):
    """The model with a forward that runs any function of it: DDP wraps this,
    so a step's whole differentiable computation is one DDP forward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn: Callable, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


class DataParallel:
    """`model` replicated on every rank of `group` (the whole process group
    when None; the data group of a grid with a model axis) under
    `DistributedDataParallel`. `dp(fn, *args)` runs `fn(model, *args)` as a
    DDP forward (the backward of its result all-reduces the gradients over
    the group, their mean); `sum` and `mean` reduce a tensor over its
    ranks, and `world` counts them."""

    def __init__(self, model: nn.Module, device: torch.device, group=None):
        if not is_distributed():
            raise RuntimeError("DataParallel needs the process group (init_distributed)")
        self.module, self.group = model, group
        self.world = dist.get_world_size(group)
        self.ddp = nn.parallel.DistributedDataParallel(
            _Apply(model), device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, process_group=group)

    def __call__(self, fn: Callable, *args, **kwargs):
        return self.ddp(fn, *args, **kwargs)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum(x) / self.world


class Local:
    """One process's stand-in for `DataParallel`: a world of one, where
    `local(fn, *args)` is `fn(model, *args)` and `sum` and `mean` over the
    ranks return the tensor itself, detached. The steps run this one path
    with or without the process group."""

    world = 1

    def __init__(self, model: nn.Module):
        self.module = model

    def __call__(self, fn: Callable, *args, **kwargs):
        return fn(self.module, *args, **kwargs)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach()

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach()


def replicated(model) -> "DataParallel | Local":
    """`model` if it is a DataParallel already, else its `Local` stand-in."""
    return model if isinstance(model, DataParallel) else Local(model)
