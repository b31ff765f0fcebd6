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

Tensor parallelism over a model axis (the JAX package's `_MODEL_AXIS_RULES`)
is not ported: `check_model_axis` refuses `--n_model` above 1.
"""
from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn


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


def check_model_axis(n_model: int) -> None:
    if n_model > 1:
        raise SystemExit(
            f"--n_model {n_model}: tensor parallelism over a model axis is not ported "
            "(ROADMAP A5); the port is data parallel only (--distributed)")


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
