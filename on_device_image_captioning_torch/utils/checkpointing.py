"""Checkpoint save/load: the whole training state, with rotation and resume
(counterpart of the JAX package's `utils/checkpointing.py`, which rebuilds
the reference's utils/saving_utils.py:8-128).

A checkpoint is one `torch.save` file of

    {"params": the model's state_dict (the reference's parameter names),
     "opt_state": the optimizer's state_dict, "step": int,
     "data_loader_state": the loader's cursor (`data/loader.py`)}

so a restart resumes mid-epoch at the exact batch. It holds only tensors,
numbers, strings, lists and dicts, and loads with `weights_only=True`. Files
are named `checkpoint_<ts>_epoch{E}it{I}bs{B}_{info}_` as the JAX package
names them (no suffix; `_NAME` parses either package's), and rotation keeps
the newest `num_max_checkpoints`. `load_most_recent` scans a directory.

Partial loads and the layer-removal surgery live in `params/surgery.py`.
"""
from __future__ import annotations

import os
import re
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

import torch

_FMT = "%Y-%m-%d-%H.%M.%S.%f"  # sub-second so rapid saves never collide
_NAME = re.compile(r"^checkpoint_(?P<ts>[^_]+)_epoch\d+it\d+bs\d+_(?P<info>[^_]+)_$")


def _to_cpu(tree):
    """Detached CPU copies of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    save_dir: str,
    params: Dict[str, torch.Tensor],
    opt_state: Any = None,
    step: int = 0,
    data_loader_state: Optional[Dict] = None,
    additional_info: str = "noinfo",
    num_max_checkpoints: int = 3,
    epoch_it: int = 0,
    batch_it: int = 0,
    batch_size: int = 0,
    verbose: bool = False,
) -> str:
    """Write a rotating checkpoint; returns the new file path."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "params": _to_cpu(dict(params)),
        "opt_state": _to_cpu(opt_state),
        "step": int(step),
        "data_loader_state": data_loader_state,
    }

    stamped = []
    for f in os.listdir(save_dir):
        m = _NAME.match(f)
        if m:
            stamped.append((datetime.strptime(m.group("ts"), _FMT), f))
    stamped.sort()
    if len(stamped) >= num_max_checkpoints and stamped:
        os.remove(os.path.join(save_dir, stamped[0][1]))

    name = (
        f"checkpoint_{datetime.now().strftime(_FMT)}"
        f"_epoch{epoch_it}it{batch_it}bs{batch_size}_{additional_info}_"
    )
    path = os.path.join(save_dir, name)
    torch.save(payload, path + ".tmp")  # whole or absent: no half-written checkpoint
    os.replace(path + ".tmp", path)
    if verbose:
        print(f"Saved to {name}", flush=True)
    return path


def load_checkpoint(path: str) -> Dict:
    """A checkpoint's payload, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_most_recent(save_dir: str, verbose: bool = False) -> Tuple[Optional[Dict], str]:
    """The newest checkpoint of the directory (reference
    utils/saving_utils.py:8-52): (payload | None, its info tag)."""
    if not os.path.isdir(save_dir):
        return None, "no_additional_info"
    newest = None
    info = "no_additional_info"
    for f in os.listdir(save_dir):
        m = _NAME.match(f)
        if not m:
            continue
        ts = datetime.strptime(m.group("ts"), _FMT)
        if newest is None or ts > newest[0]:
            newest = (ts, f)
            info = m.group("info")
    if newest is None:
        if verbose:
            print(f"Loading: no checkpoint found in {save_dir}", flush=True)
        return None, info
    if verbose:
        print(f"Loading: {os.path.join(save_dir, newest[1])}", flush=True)
    return load_checkpoint(os.path.join(save_dir, newest[1])), info
