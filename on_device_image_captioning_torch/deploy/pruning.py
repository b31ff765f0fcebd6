"""Magnitude pruning: global L1 unstructured, with sparse checkpoints
(counterpart of the JAX package's `deploy/pruning.py`; reference
benchmarking/benchmarking.py:123-151: torch.nn.utils.prune.global_unstructured
L1 at 33% per round, repeated; the sparsity report; the sparse checkpoint;
and test.py:455-459's --load_pruned path).

The port works on a model's state_dict (the reference's names) where the JAX
package works on its parameter tree, with the same semantics:

- the tensors pruned are the JAX tree's `w` leaves of two or more dims: the
  weights of the linears and of the patch-embed convolution
  (`params/convert.py::w_leaf_names`, the converter's own mapping);
- one global threshold, `np.partition` over the magnitudes of those tensors'
  nonzero entries in fp32, at `amount` of their count; every entry at or
  below it is zeroed, so repeated rounds compound;
- the report counts every state_dict tensor of two or more dims (the JAX
  params of two or more dims: the non-parameter buffers, such as
  `relative_position_index` and the attention masks, are not in a
  state_dict);
- `save_sparse` stores a tensor of two or more dims with more than 25% zeros
  as its nonzero flat indices (int32) and values, every other tensor dense:
  npz keys `name::idx`, `name::val`, `name::shape`, `name::dense`.

Pruned weights run as dense zeros, as in the reference; the win is the
checkpoint.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def global_l1_prune(state_dict: Mapping, names: Iterable[str],
                    amount: float = 0.33) -> Dict[str, torch.Tensor]:
    """Zero the globally smallest |w| entries across the tensors `names`
    (`params/convert.py::w_leaf_names` of the model) so that `amount` of
    their nonzero entries are removed. Returns a new state_dict: the pruned
    tensors copied, every other entry as it was."""
    names = [n for n in names if state_dict[n].dim() >= 2]
    mags = []
    for n in names:
        a = np.abs(np.asarray(_numpy(state_dict[n]), np.float32)).ravel()
        mags.append(a[a > 0])
    allmags = np.concatenate(mags) if mags else np.zeros(1)
    k = int(len(allmags) * amount)
    out = dict(state_dict)
    if k == 0:
        return out
    threshold = np.partition(allmags, k - 1)[k - 1]
    for n in names:
        t = state_dict[n]
        a = _numpy(t)
        pruned = np.where(np.abs(a) <= threshold, 0.0, a).astype(a.dtype)
        out[n] = torch.from_numpy(pruned).to(device=t.device, dtype=t.dtype)
    return out


def sparsity_report(state_dict: Mapping) -> Dict[str, float]:
    """Per-tensor and global zero fractions over the tensors of two or more
    dims (the reference prints the same table)."""
    report = {}
    total = zeros = 0
    for name, t in _tensors(state_dict).items():
        if t.dim() >= 2:
            z = int((t == 0).sum())
            report[name] = z / t.numel()
            total += t.numel()
            zeros += z
    report["GLOBAL"] = zeros / max(total, 1)
    return report


def save_sparse(path: str, state_dict: Mapping) -> None:
    """Store a pruned state_dict as an npz: {name::(shape, nonzero idx,
    nonzero values)} for tensors of two or more dims above 25% zeros,
    {name::dense} for the rest. Non-tensor entries are not stored."""
    payload = {}
    for name, t in _tensors(state_dict).items():
        a = _numpy(t)
        if a.ndim >= 2 and (a == 0).mean() > 0.25:
            idx = np.flatnonzero(a).astype(np.int32)
            payload[f"{name}::idx"] = idx
            payload[f"{name}::val"] = a.ravel()[idx]
            payload[f"{name}::shape"] = np.asarray(a.shape, np.int32)
        else:
            payload[f"{name}::dense"] = a
    np.savez_compressed(path, **payload)


def load_sparse(path: str, template: Mapping) -> Dict[str, torch.Tensor]:
    """Rebuild a dense state_dict from a sparse npz over a template's names
    and dtypes (a model of the configured shape: `model.state_dict()`); its
    non-tensor entries are kept."""
    data = np.load(path)
    out = {}
    for name, t in template.items():
        if not isinstance(t, torch.Tensor):
            out[name] = t
            continue
        if f"{name}::dense" in data:
            a = data[f"{name}::dense"]
        else:
            shape = tuple(int(v) for v in data[f"{name}::shape"])
            a = np.zeros(int(np.prod(shape)), data[f"{name}::val"].dtype)
            a[data[f"{name}::idx"]] = data[f"{name}::val"]
            a = a.reshape(shape)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(t.dtype)
    return out
