"""State_dict surgery: partial loads and layer-removal remapping (counterpart of
the JAX package's `params/surgery.py`, which works on parameter trees; here the
same operations work on state_dicts in the reference repo's names).

- `partially_load`: copy matching tensors from a source state_dict into a
  target one, keeping the target's where the source has none or another shape
  (reference utils/saving_utils.py:113-128 partially_load_state_dict, used for
  backbone-only / body-only warm starts);
- `remove_layer`: the param_config 1/2 ablations (reference train.py:305-342):
  drop encoder (and optionally decoder) layer 1, renumber layer 2 to slot 1,
  and slice the 3-chunk reduce_group weights down to their first and last
  chunks;
- `reinit_patch_embed_3x3`: the 288px/patch-3 experiment re-initializes the
  patch-embed projection to a (3, 3) kernel (reference train.py:309-312).

Each returns a new dict and leaves its input as it was.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import torch


def partially_load(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
                   verbose: bool = False) -> Dict[str, torch.Tensor]:
    """Copy source tensors into target wherever key and shape match; leave the
    rest of target as it is."""
    out = {}
    for key, leaf in target.items():
        s = source.get(key)
        if s is not None and tuple(s.shape) == tuple(leaf.shape):
            if verbose:
                print(f"Found: {key}", flush=True)
            out[key] = s
            continue
        if verbose and s is None:
            print(f"Not found: {key}", flush=True)
        out[key] = leaf
    return out


def _slice_reduce_group(w: torch.Tensor, n_layers_before: int) -> torch.Tensor:
    """reduce_group weight (d_model, d_model * N) in torch (out, in) layout: keep
    the first and last of the N input chunks (reference train.py:319-336)."""
    chunk = w.shape[1] // n_layers_before
    return torch.cat([w[:, :chunk], w[:, -chunk:]], dim=1)


def stack_depth(sd: Mapping[str, torch.Tensor], stack: str) -> int:
    """Number of layers of `stack` ("encoders" or "decoders") in a caption-head
    (or end-to-end) state_dict: the distinct `<stack>.<i>.` indices."""
    pat = re.compile(rf"^{stack}\.(\d+)\.")
    return len({m.group(1) for m in map(pat.match, sd) if m})


def _drop_layer_1(sd: Dict[str, torch.Tensor], stack: str) -> Dict[str, torch.Tensor]:
    if stack_depth(sd, stack) != 3:
        raise ValueError("layer removal assumes the 3-layer reference stack")
    out = {}
    for key, v in sd.items():
        if key.startswith(f"{stack}.1."):
            continue
        if key.startswith(f"{stack}.2."):
            key = f"{stack}.1." + key[len(f"{stack}.2."):]
        out[key] = v
    reduce = "enc_reduce_group.weight" if stack == "encoders" else "dec_reduce_group.weight"
    out[reduce] = _slice_reduce_group(sd[reduce], 3)
    return out


def remove_layer(sd: Mapping[str, torch.Tensor], param_config: int) -> Dict[str, torch.Tensor]:
    """param_config: 1 = drop encoder layer 1; 2 = drop encoder AND decoder
    layer 1. The caption head's keys are at the top level of `sd` (a
    caption-head or end-to-end state_dict); the canonical 3-layer stacks are
    assumed."""
    out = dict(sd)
    if param_config in (1, 2):
        out = _drop_layer_1(out, "encoders")
    if param_config == 2:
        out = _drop_layer_1(out, "decoders")
    return out


def reinit_patch_embed_3x3(sd: Mapping[str, torch.Tensor], generator: torch.Generator,
                           embed_dim: int = 192, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Re-initialize the patch-embed projection for patch-size-3 inputs: a
    (embed_dim, 3, 3, 3) convolution kernel uniform in +-sqrt(6 / 27) (kaiming
    uniform over a fan-in of 3 * 3 * 3), drawn from `generator`, and a zero bias
    (reference train.py:309-312). `prefix` is "swin_transf." in an end-to-end
    state_dict, "" in a backbone's."""
    bound = math.sqrt(6.0 / (3 * 3 * 3))
    u = torch.rand((embed_dim, 3, 3, 3), generator=generator, device=generator.device)
    out = dict(sd)
    out[prefix + "patch_embed.proj.weight"] = (2 * u - 1) * bound
    out[prefix + "patch_embed.proj.bias"] = torch.zeros((embed_dim,), device=generator.device)
    return out
