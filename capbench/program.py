"""The benchmark's one door into the program under test
(`on_device_image_captioning_torch`): the model built from a configuration
file, with weights drawn from the seed on the card.

Nothing here runs on import; the program is imported inside the functions.
"""
from __future__ import annotations

from typing import Dict

import torch

from .weights import draw_weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(cfg: Dict):
    """The program's `ModelConfig` from a configuration file's dict."""
    from on_device_image_captioning_torch.config import (
        CaptionerConfig, DropConfig, ModelConfig, SwinConfig)

    s, c = dict(cfg["swin"]), dict(cfg["captioner"])
    swin = SwinConfig(
        img_size=s["img_size"], patch_size=s["patch_size"], in_chans=s["in_chans"],
        embed_dim=s["embed_dim"], depths=tuple(s["depths"]), num_heads=tuple(s["num_heads"]),
        window_size=s["window_size"], mlp_ratio=s["mlp_ratio"], qkv_bias=s["qkv_bias"],
        ln_eps=s["ln_eps"], drop_path_rate=s["drop_path_rate"],
        attention_impl=s["attention_impl"])
    cap = CaptionerConfig(
        d_model=c["d_model"], N_enc=c["N_enc"], N_dec=c["N_dec"], ff=c["ff"],
        num_heads=c["num_heads"], num_exp_enc_list=tuple(c["num_exp_enc_list"]),
        num_exp_dec=c["num_exp_dec"], vocab_size=c["vocab_size"], max_seq_len=c["max_seq_len"],
        img_feature_dim=c["img_feature_dim"], sos_idx=c["sos_idx"], eos_idx=c["eos_idx"],
        pad_idx=c["pad_idx"], unk_idx=c["unk_idx"], drop=DropConfig(**c["drop"]), eps=c["eps"],
        ln_eps=c["ln_eps"], attn_fill=c["attn_fill"])
    return ModelConfig(swin=swin, captioner=cap, compute_dtype=DTYPES[cfg["compute_dtype"]])


def build_model(cfg: Dict, seed: int, device):
    """(ModelConfig, EndExpansionNetV2 on `device` with the seed's weights,
    the weights dict). The module is made on `device`, so its own default
    initialisation runs there before the seed's weights replace it."""
    from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
    from on_device_image_captioning_torch.ops import _build

    if torch.device(device).type == "cuda":
        _build.compile_all()  # every kernel at once; served from the build directory after
    mcfg = model_config(cfg)
    with torch.device(device):
        model = EndExpansionNetV2(mcfg)
    model = model.to(device)
    weights = draw_weights(((n, p.shape) for n, p in model.named_parameters()), seed, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return mcfg, model, weights


def param_shapes(cfg: Dict):
    """[(name, shape)] of every parameter of the configuration's model, from
    a model made on the meta device (no memory, no initialisation)."""
    from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2

    with torch.device("meta"):
        model = EndExpansionNetV2(model_config(cfg))
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]
