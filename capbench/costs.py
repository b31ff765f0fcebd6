"""The frozen cost table: multiply-accumulates of the model, and the least
time each function of a cell's work needs on the card.

The MAC counts are a copy, formula for formula, of the program's
`deploy/analysis.py` (which follows the reference repository's flops()
methods: a multiply-accumulate is counted once, so FLOPs = 2 x MACs). They
are kept here so that a change to the program cannot change the yardstick;
`capbench/tests/test_costs.py` holds the copy equal to the original.

A configuration is the plain dict of `capbench/configs/<name>.json`
("swin" and "captioner" groups), never the program's dataclasses.

`bound_s(functions)`: each function is (MACs, bytes); the least time it
needs is max(2 x MACs / peak, bytes / bandwidth) on the published peaks of
one H100 SXM (dense bf16 989 TFLOP/s, HBM 3.35 TB/s), and the least time of a
stretch of work is the sum over its functions. A function is a whole Swin
block, a patch embed, a patch merging, the caption encoder, one decode step
or an optimizer update: each reads its inputs and weights once and writes
its outputs once, whatever kernels implement it, so the bound holds for a
fused and an unfused program alike. Activations and weights count 2 bytes
(bf16), gradients of the fp32 master weights and the optimizer state 4.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
ACT = 2  # bytes of a bf16 activation or weight
F32 = 4


# ---------------------------------------------------------------------------
# geometry of the plain configuration dicts
# ---------------------------------------------------------------------------


def _res(swin: dict, i: int) -> int:
    return swin["img_size"] // swin["patch_size"] // 2**i


def _dim(swin: dict, i: int) -> int:
    return swin["embed_dim"] * 2**i


def _window(swin: dict, i: int) -> int:
    return min(swin["window_size"], _res(swin, i))


def num_features(swin: dict) -> int:
    return _dim(swin, len(swin["depths"]) - 1)


def enc_tokens(swin: dict) -> int:
    return _res(swin, len(swin["depths"]) - 1) ** 2


# ---------------------------------------------------------------------------
# MACs (copy of deploy/analysis.py)
# ---------------------------------------------------------------------------


def swin_block_macs(swin: dict, i: int) -> int:
    dim, h = _dim(swin, i), _res(swin, i)
    heads, n = swin["num_heads"][i], _window(swin, i) ** 2
    nw = h * h / n
    attn = n * dim * 3 * dim + heads * n * (dim // heads) * n * 2 + n * dim * dim
    return (dim * h * h + int(nw * attn) + int(2 * h * h * dim * dim * swin["mlp_ratio"])
            + dim * h * h)


def patch_embed_macs(swin: dict) -> int:
    ho = swin["img_size"] // swin["patch_size"]
    return ho * ho * swin["embed_dim"] * 3 * swin["patch_size"] ** 2 + ho * ho * swin["embed_dim"]


def merge_macs(swin: dict, i: int) -> int:
    dim, h = _dim(swin, i), _res(swin, i)
    return h * h * dim + (h // 2) * (h // 2) * 4 * dim * 2 * dim


def swin_macs(swin: dict) -> int:
    total = patch_embed_macs(swin)
    for i, depth in enumerate(swin["depths"]):
        total += depth * swin_block_macs(swin, i)
        if i < len(swin["depths"]) - 1:
            total += merge_macs(swin, i)
    return int(total)


def encoder_macs(cap: dict, s_enc: int) -> int:
    d, e = cap["d_model"], sum(cap["num_exp_enc_list"])
    per_layer = (4 * s_enc * d * d + 2 * e * s_enc * d + 2 * e * s_enc * d + 2 * s_enc * e * d
                 + 2 * s_enc * d * cap["ff"])
    total = cap["N_enc"] * per_layer
    total += s_enc * cap["img_feature_dim"] * d
    total += s_enc * (cap["N_enc"] * d) * d
    return int(total)


def decoder_full_prefix_macs(cap: dict, t: int, s_enc: int) -> int:
    d, e = cap["d_model"], cap["num_exp_dec"]
    per_layer = (5 * t * d * d + 2 * (t * e) * t * d + 2 * t * (t * e) * d + 2 * t * d * d
                 + 2 * s_enc * d * d + 2 * t * s_enc * d + 2 * t * d * cap["ff"])
    total = cap["N_dec"] * per_layer
    total += t * (cap["N_dec"] * d) * d
    total += t * d * cap["vocab_size"]
    return int(total)


def decoder_step_macs(cap: dict, t: int, s_enc: int) -> int:
    d, e = cap["d_model"], cap["num_exp_dec"]
    per_layer = (5 * d * d + e * t * d + 2 * e * t * d + t * e * d + 2 * t * e * d + 2 * d * d
                 + 2 * s_enc * d + 2 * d * cap["ff"])
    total = cap["N_dec"] * per_layer
    total += (cap["N_dec"] * d) * d
    total += d * cap["vocab_size"]
    return int(total)


def beam_search_macs(cfg: dict, beam: int, steps: int) -> Dict[str, int]:
    """Per image: backbone, caption encoder and `steps` incremental decode
    steps of `beam` beams (deploy/analysis.py::beam_search_flops)."""
    swin, cap = cfg["swin"], cfg["captioner"]
    s_enc = enc_tokens(swin)
    backbone, encoder = swin_macs(swin), encoder_macs(cap, s_enc)
    dec = sum(beam * decoder_step_macs(cap, t + 1, s_enc) for t in range(steps))
    dec += cap["N_dec"] * 2 * s_enc * cap["d_model"] ** 2
    return {"backbone": backbone, "encoder": encoder, "decode": int(dec),
            "total": int(backbone + encoder + dec)}


def xe_step_macs(cfg: dict, seq_len: int) -> Dict[str, int]:
    """Per image, one XE step without recomputation: 3 x the forward
    (deploy/analysis.py::xe_train_step_flops with remat=False)."""
    swin, cap = cfg["swin"], cfg["captioner"]
    s_enc = enc_tokens(swin)
    backbone_fwd = swin_macs(swin)
    head_fwd = encoder_macs(cap, s_enc) + decoder_full_prefix_macs(cap, seq_len, s_enc)
    return {"backbone_fwd": backbone_fwd, "head_fwd": head_fwd,
            "backbone_train": 3 * backbone_fwd, "head_train": 3 * head_fwd,
            "total": 3 * backbone_fwd + 3 * head_fwd}


# ---------------------------------------------------------------------------
# functions and their least times
# ---------------------------------------------------------------------------

Function = Tuple[int, int]  # (MACs, bytes)


def bound_s(functions: Iterable[Function]) -> float:
    return sum(max(2 * macs / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
               for macs, nbytes in functions)


def _block_weights(dim: int, mlp_ratio: float) -> int:
    return int(4 * dim * dim + 2 * dim * dim * mlp_ratio)


def backbone_functions(swin: dict, batch: int) -> List[Function]:
    """The backbone's functions over a batch of uint8 images."""
    img = swin["img_size"]
    l0 = (img // swin["patch_size"]) ** 2
    out = [(batch * patch_embed_macs(swin),
            batch * img * img * 3 + batch * l0 * swin["embed_dim"] * ACT)]
    for i, depth in enumerate(swin["depths"]):
        dim, tokens = _dim(swin, i), _res(swin, i) ** 2
        act = batch * tokens * dim * ACT
        for _ in range(depth):
            out.append((batch * swin_block_macs(swin, i),
                        2 * act + _block_weights(dim, swin["mlp_ratio"]) * ACT))
        if i < len(swin["depths"]) - 1:
            out.append((batch * merge_macs(swin, i), act + act // 2 + 8 * dim * dim * ACT))
    f = num_features(swin)
    out.append((0, 2 * batch * enc_tokens(swin) * f * ACT))  # final norm
    return out


def head_weights(cap: dict, part: str) -> int:
    d, ff = cap["d_model"], cap["ff"]
    if part == "encoder":
        return (cap["N_enc"] * (4 * d * d + 2 * d * ff + 2 * sum(cap["num_exp_enc_list"]) * d)
                + cap["img_feature_dim"] * d + cap["N_enc"] * d * d)
    return (cap["N_dec"] * (9 * d * d + 2 * d * ff + 2 * cap["num_exp_dec"] * d)
            + cap["N_dec"] * d * d + 2 * d * cap["vocab_size"])


def encoder_function(cfg: dict, batch: int) -> Function:
    swin, cap = cfg["swin"], cfg["captioner"]
    s = enc_tokens(swin)
    return (batch * encoder_macs(cap, s),
            batch * s * (cap["img_feature_dim"] + cap["d_model"]) * ACT
            + head_weights(cap, "encoder") * ACT)


def decode_functions(cfg: dict, batch: int, beam: int, max_len: int) -> List[Function]:
    """A beam decode of max_len - 1 steps: the first on one row an image,
    the rest on `beam` rows; each step reads the decoder's weights and the
    encoder output and writes its fp32 log-probs."""
    cap = cfg["captioner"]
    s = enc_tokens(cfg["swin"])
    d, v = cap["d_model"], cap["vocab_size"]
    kv = (batch * cap["N_dec"] * 2 * s * d * d,
          batch * s * d * ACT + cap["N_dec"] * 2 * d * d * ACT + batch * cap["N_dec"] * 2 * s
          * d * ACT)
    out = [kv]
    weights = head_weights(cap, "decoder") * ACT
    for t in range(max_len - 1):
        rows = batch if t == 0 else batch * beam
        out.append((rows * decoder_step_macs(cap, t + 1, s),
                    weights + batch * s * d * ACT + rows * v * F32))
    return out


def serve_request_functions(cfg: dict, batch: int, beam: int, max_len: int) -> List[Function]:
    return (backbone_functions(cfg["swin"], batch) + [encoder_function(cfg, batch)]
            + decode_functions(cfg, batch, beam, max_len))


def param_count(cfg: dict) -> int:
    """Parameters of the end-to-end model (the weights of every linear and
    table; norms and biases are below a tenth of a percent and left out)."""
    swin, cap = cfg["swin"], cfg["captioner"]
    n = 3 * swin["patch_size"] ** 2 * swin["embed_dim"]
    for i, depth in enumerate(swin["depths"]):
        dim = _dim(swin, i)
        n += depth * _block_weights(dim, swin["mlp_ratio"])
        if i < len(swin["depths"]) - 1:
            n += 8 * dim * dim
    return n + head_weights(cap, "encoder") + head_weights(cap, "decoder")


def xe_step_functions(cfg: dict, batch: int, seq_len: int) -> List[Function]:
    """One XE step: every forward function three times over (forward,
    input gradient, weight gradient) with its activations read and written
    twice and its weights' fp32 gradients written, then one RAdam update
    (reads parameter, gradient and two moments, writes parameter and moments,
    fp32)."""
    swin, cap = cfg["swin"], cfg["captioner"]
    s = enc_tokens(swin)
    fwd = backbone_functions(swin, batch)
    fwd.append(encoder_function(cfg, batch))
    fwd.append((batch * decoder_full_prefix_macs(cap, seq_len, s),
                batch * seq_len * cap["d_model"] * ACT * 2 + head_weights(cap, "decoder") * ACT
                + batch * seq_len * cap["vocab_size"] * F32))
    out = [(3 * macs, 2 * nbytes) for macs, nbytes in fwd]
    out.append((0, 7 * F32 * param_count(cfg)))
    return out
