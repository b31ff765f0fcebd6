"""Weights across the two packages.

`state_dict_from_jax` turns the JAX package's end-to-end parameter tree (as
numpy arrays) into this package's state_dict, which carries the reference
repo's names. It is the inverse of the JAX package's
`params/torch_convert.py::convert_end_to_end`: linears are transposed back to
(out, in), the patch-embed matmul goes back to the Conv2d layout, and the
relative-position tables stay tables (a pre-expanded `rel_bias_x` is
ignored). A quantized JAX tree (`deploy/quantization.py::quantize_tree` there)
converts too: a node {'w_q' (in, out), 'scale', ['b'], ['x_scale'], ['a8']}
becomes the buffers of a `QuantLinear` (w_q transposed to (out, in), the mode
in its extra state; the patch-embed node keeps its (u, v, c) matrix), which
`deploy/quantization.py::load_quantized_state_dict` builds the modules for.

`load_reference_state_dict` loads a reference `.pth` state_dict: it drops the
DDP `module.` prefix and the non-parameter buffers the reference saves
(`attn_mask`, `relative_position_index`), then loads strictly; a quantized
state_dict (`cli/quantize.py` writes one) gets its `QuantLinear`s first.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..deploy.quantization import load_quantized_state_dict


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _lin(sd: Dict, prefix: str, p: Mapping, conv=None) -> None:
    if "w_q" in p:  # int8-quantized node
        sd[prefix + ".w_q"] = torch.from_numpy(np.array(p["w_q"], dtype=np.int8).T.copy())
        sd[prefix + ".scale"] = _t(p["scale"])
        if "x_scale" in p:
            sd[prefix + ".x_scale"] = _t(p["x_scale"]).reshape(())
        sd[prefix + "._extra_state"] = {"mode": "a8" if "a8" in p else "w8", "conv": conv}
    else:
        sd[prefix + ".weight"] = _t(p["w"]).T.contiguous()
    if "b" in p:
        sd[prefix + ".bias"] = _t(p["b"])


def _ln(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _emb(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["embed"])


def captioner_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Caption-head tree -> reference-named state_dict entries."""
    sd: Dict[str, torch.Tensor] = {}
    g = lambda name: prefix + name  # noqa: E731
    _lin(sd, g("input_linear"), params["input_linear"])
    _lin(sd, g("vocab_linear"), params["vocab_linear"])
    _emb(sd, g("out_embedder.embed"), params["out_embedder"])
    _emb(sd, g("pos_encoder"), params["pos_encoder"])
    _lin(sd, g("enc_reduce_group"), params["enc_reduce_group"])
    _ln(sd, g("enc_reduce_norm"), params["enc_reduce_norm"])
    _lin(sd, g("dec_reduce_group"), params["dec_reduce_group"])
    _ln(sd, g("dec_reduce_norm"), params["dec_reduce_norm"])
    for i, enc in enumerate(params["encoders"]):
        e = g(f"encoders.{i}.")
        _ln(sd, e + "norm_1", enc["norm_1"])
        _ln(sd, e + "norm_2", enc["norm_2"])
        stc = enc["stc_exp"]
        _emb(sd, e + "stc_exp.query_exp_vectors", stc["query_exp"])
        _emb(sd, e + "stc_exp.bias_exp_vectors", stc["bias_exp"])
        for name in ("key_embed", "class_a_embed", "class_b_embed", "selector_embed"):
            _lin(sd, e + "stc_exp." + name, stc[name])
        _lin(sd, e + "ff.linear_1", enc["ff"]["linear_1"])
        _lin(sd, e + "ff.linear_2", enc["ff"]["linear_2"])
    for i, dec in enumerate(params["decoders"]):
        d = g(f"decoders.{i}.")
        for n in ("norm_1", "norm_2", "norm_3"):
            _ln(sd, d + n, dec[n])
        dyn = dec["dyn_exp"]
        _emb(sd, d + "dyn_exp.query_exp_vectors", dyn["query_exp"])
        _emb(sd, d + "dyn_exp.bias_exp_vectors", dyn["bias_exp"])
        for name in ("cond_embed", "key_linear", "class_a_embed", "class_b_embed",
                     "selector_embed"):
            _lin(sd, d + "dyn_exp." + name, dyn[name])
        for name in ("Wq", "Wk", "Wv", "out_linear"):
            _lin(sd, d + "mha." + name, dec["mha"][name])
        _lin(sd, d + "ff.linear_1", dec["ff"]["linear_1"])
        _lin(sd, d + "ff.linear_2", dec["ff"]["linear_2"])
    return sd


def swin_state_dict(params: Mapping, cfg: ModelConfig, prefix: str = "swin_transf.") -> Dict:
    """Swin tree -> reference-named state_dict entries."""
    scfg = cfg.swin
    sd: Dict[str, torch.Tensor] = {}
    pe = params["patch_embed"]
    ps, c = scfg.patch_size, scfg.in_chans
    if "w_q" in pe["proj"]:
        _lin(sd, prefix + "patch_embed.proj", pe["proj"], conv=(ps, c))
    else:
        w = _t(pe["proj"]["w"])  # (kh*kw*C, O) in (u, v, c) order
        sd[prefix + "patch_embed.proj.weight"] = (
            w.T.reshape(-1, ps, ps, c).permute(0, 3, 1, 2).contiguous()
        )
        sd[prefix + "patch_embed.proj.bias"] = _t(pe["proj"]["b"])
    if pe.get("norm") is not None:
        _ln(sd, prefix + "patch_embed.norm", pe["norm"])
    if scfg.ape:
        sd[prefix + "absolute_pos_embed"] = _t(params["ape"])
    for i, stage in enumerate(params["stages"]):
        for j, blk in enumerate(stage["blocks"]):
            b = f"{prefix}layers.{i}.blocks.{j}."
            _ln(sd, b + "norm1", blk["norm1"])
            _lin(sd, b + "attn.qkv", blk["attn"]["qkv"])
            _lin(sd, b + "attn.proj", blk["attn"]["proj"])
            sd[b + "attn.relative_position_bias_table"] = _t(blk["attn"]["rel_bias"])
            _ln(sd, b + "norm2", blk["norm2"])
            _lin(sd, b + "mlp.fc1", blk["mlp"]["fc1"])
            _lin(sd, b + "mlp.fc2", blk["mlp"]["fc2"])
        if "downsample" in stage:
            ds = f"{prefix}layers.{i}.downsample."
            _ln(sd, ds + "norm", stage["downsample"]["norm"])
            _lin(sd, ds + "reduction", stage["downsample"]["reduction"])
    _ln(sd, prefix + "norm", params["norm"])
    return sd


def state_dict_from_jax(params_np: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX end-to-end tree {'swin', 'captioner'} (numpy leaves) -> this
    package's `EndExpansionNetV2` state_dict."""
    return {
        **swin_state_dict(params_np["swin"], cfg),
        **captioner_state_dict(params_np["captioner"]),
    }


# The modules whose `.weight` the converter fills from a `w` leaf of the JAX
# tree: `_lin` writes the weight of exactly the model's `nn.Linear`s (a strict
# load of `state_dict_from_jax` holds the two to each other), and
# `swin_state_dict` the patch embed's `nn.Conv2d` from its `proj/w`. The other
# weights come from `embed` (`_emb`: `nn.Embedding`), `scale` (`_ln`:
# `nn.LayerNorm`), `rel_bias` and `ape` leaves.
W_LEAF_MODULES = (nn.Linear, nn.Conv2d)


def w_leaf_names(model: nn.Module) -> List[str]:
    """The state_dict names of `model` that hold the JAX tree's `w` leaves
    (by `W_LEAF_MODULES`), in the state_dict's order."""
    owners = {name for name, m in model.named_modules() if type(m) in W_LEAF_MODULES}
    return [k for k in model.state_dict() if k.endswith(".weight")
            and k[: -len(".weight")] in owners]


def clean_reference_state_dict(sd: Mapping) -> Dict:
    """A reference checkpoint's state_dict (or a full training checkpoint with
    a 'model_state_dict' key) without the DDP `module.` prefix and the
    non-parameter buffers (`attn_mask`, `relative_position_index`)."""
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    clean = {}
    for k, v in sd.items():
        k = re.sub(r"^module\.", "", k)
        if k.endswith("attn_mask") or k.endswith("relative_position_index"):
            continue
        clean[k] = v
    return clean


def load_reference_state_dict(model: nn.Module, sd: Mapping) -> None:
    """Load a reference checkpoint's state_dict (or a full training checkpoint
    with a 'model_state_dict' key) strictly into `model`, quantized linears
    included."""
    load_quantized_state_dict(model, clean_reference_state_dict(sd))
