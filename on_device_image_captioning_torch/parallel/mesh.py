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

Serving and evaluation also take a model axis (the JAX package's
`make_mesh(n_data, n_model)` and `_MODEL_AXIS_RULES`): `make_grid` cuts a
world of W processes into `W / n_model` data ranks by `n_model` model ranks,
each model group consecutive ranks; `shard_model` replaces every layer the
rule table (`MODEL_AXIS_RULES`, the JAX rules in the reference's parameter
names) matches by its rank's slice (`parallel/tensor.py`), so a model group
runs one model and meets only inside itself during a decode. The
collectives over the whole world are `gather_predictions` (per-image
predictions to rank 0, the counterpart of `local_rows` / `host_copy` for
evaluation) and the sums of `all_reduce_sum`. `check_model_axis` refuses
what is not ported: training and `--quantize` with `--n_model` above 1.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

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


def check_model_axis(n_model: int, training: bool = False, quantize: str = "none") -> None:
    """Refuse what the port does not run over a model axis: training (the
    rules shard only serving; ROADMAP A8) and int8 weights (a row-parallel
    w8a8 linear needs the whole row's absmax; ROADMAP A9). Widths the axis
    does not divide are refused by `shard_model`, which names the layer."""
    if n_model < 1:
        raise SystemExit(f"--n_model {n_model}: the model axis takes 1 or more ranks")
    if n_model == 1:
        return
    if training:
        raise SystemExit(
            f"--n_model {n_model}: tensor-parallel training is not ported (ROADMAP A8: "
            "autograd through the collectives, DDP over the data group, sharded optimizer "
            "moments); cli/train.py takes --n_model 1 with --distributed (data parallel), "
            "and cli/evaluate.py takes --n_model above 1")
    if quantize != "none":
        raise SystemExit(
            f"--n_model {n_model} with --quantize {quantize}: int8 weights are not sharded "
            "(ROADMAP A9: a row-parallel w8a8 linear needs the activation's absmax over "
            "the whole row); use --n_model 1 with --quantize")


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
    if n_model > 1 and not is_distributed():
        raise SystemExit(f"--n_model {n_model} needs --distributed: one process a card, "
                         "n_model processes a model group")
    if n_model < 1 or world % n_model:
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


def model_axis_layers(model: nn.Module) -> List[Tuple[str, str, str]]:
    """(module name, kind, rule) of every layer the rules cut, in module
    order. A "fused" backbone's layers are left out: its block kernels take
    whole weights and carry the residual in their epilogues (ROADMAP A10),
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


def shard_model(model: nn.Module, grid: Grid) -> List[str]:
    """Replace every layer `model_axis_layers` names by this rank's slice
    (the counterpart of the JAX `shard_params`), in place; the model stays
    on its device. Call it on the loaded weights, before `prepare_inference`
    (which expands the sliced bias tables). Returns the lines that say which
    rule cut which layers and the bytes of weights a rank holds. A width the
    axis does not divide raises, naming the layer (the port does not pad)."""
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
    group = grid.model_group
    by_rule: Dict[str, List[str]] = {}
    for name, kind, pattern in layers:
        mod = model.get_submodule(name)
        by_rule.setdefault(f"{pattern} ({kind})", []).append(name)
        w, b = mod.weight.detach(), getattr(mod, "bias", None)
        b = None if b is None else b.detach()
        if kind == "embedding":
            rows = w.shape[0] // n
            new = ShardedEmbedding(w[r * rows:(r + 1) * rows], r * rows, w.shape[0], group)
        elif kind == "row":
            cols = w.shape[1] // n
            new = ShardedLinear("row", w[:, r * cols:(r + 1) * cols], b, group)
        elif kind == "heads":
            owner = model.get_submodule(name.rpartition(".")[0])
            c, local = w.shape[0] // 3, owner.heads // n
            width = local * (c // owner.heads)
            idx = torch.cat([torch.arange(t * c + r * width, t * c + (r + 1) * width)
                             for t in range(3)]).to(w.device)
            new = ShardedLinear("column", w[idx], None if b is None else b[idx], group)
            table = owner.relative_position_bias_table.detach()
            owner.relative_position_bias_table = nn.Parameter(
                table[:, r * local:(r + 1) * local].clone(), requires_grad=False)
            owner.heads, owner.rel_bias_x = local, None
        else:
            rows = w.shape[0] // n
            sl = slice(r * rows, (r + 1) * rows)
            new = ShardedLinear("vocab" if kind == "vocab" else "column", w[sl],
                                None if b is None else b[sl], group, r * rows, w.shape[0])
        model.set_submodule(name, new)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    lines = [f"model axis: {n} ranks a model group, {grid.n_data} data ranks"]
    lines += [f"  {rule}: {len(names)} layers ({names[0]}{', ...' if len(names) > 1 else ''})"
              for rule, names in by_rule.items()]
    lines.append(f"  weights a rank holds: {held} bytes of {whole} whole")
    return lines


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
    """`model` replicated on every rank of the process group under
    `DistributedDataParallel`. `dp(fn, *args)` runs `fn(model, *args)` as a
    DDP forward (the backward of its result all-reduces the gradients, their
    mean over ranks); `sum` and `mean` reduce a tensor over ranks."""

    def __init__(self, model: nn.Module, device: torch.device):
        if not is_distributed():
            raise RuntimeError("DataParallel needs the process group (init_distributed)")
        self.module = model
        self.world = process_count()
        self.ddp = nn.parallel.DistributedDataParallel(
            _Apply(model), device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)

    def __call__(self, fn: Callable, *args, **kwargs):
        return self.ddp(fn, *args, **kwargs)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.detach().clone()
        dist.all_reduce(out)
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
