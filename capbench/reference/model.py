"""Plain PyTorch reference of Swin-L/384 + the ExpansionNet v2 caption head.

Written from the published descriptions (Swin, arXiv:2103.14030; ExpansionNet
v2, arXiv:2208.06551, and its reference repository's layers), over a flat
dict of parameters named as the reference repository names them. It imports
nothing of the program under test: no kernel, no cache, no batching tricks.

Every matrix product goes through `Precision.mm`: in "fp32" it is a float32
product (TF32 off, set by `fp32_matmul`); "fp8" rounds both operands to
float8 e4m3 with one scale per tensor first (the control of the checks).

Dropout masks are drawn as `torch.rand(shape, generator=g) < keep`, in the
order the model applies them, so a caller that hands the same generator
state gets the masks the program drew; `g=None` turns dropout off.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_matmul():
    """Float32 products stay float32 on the card (TF32 off) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per tensor (amax -> 448), back
    in float32; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


class Precision:
    """How the reference multiplies: "fp32" or "fp8" (see the module docstring)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.kind == "fp8" else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, x, w, b=None):
        y = self.mm(x, w.t())
        return y if b is None else y + b


class Drop:
    """Inverted dropout from an explicit generator; off without one."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.g = generator

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.g is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.g, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32 NHWC."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------


def rel_index(w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    c = torch.stack([ys.flatten(), xs.flatten()])  # (2, N)
    rel = c[:, :, None] - c[:, None, :] + (w - 1)
    return (rel[0] * (2 * w - 1) + rel[1]).to(device)


def shift_mask(res: int, w: int, s: int, device) -> torch.Tensor:
    """(nW, N, N) additive mask: -100 between tokens of different regions
    after the cyclic shift."""
    region = torch.zeros(res, res)
    cuts = (slice(0, -w), slice(-w, -s), slice(-s, None))
    n = 0
    for a in cuts:
        for b in cuts:
            region[a, b] = n
            n += 1
    win = region.reshape(res // w, w, res // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).to(device)


def swin_block(x, p, pre, res, w, s, heads, eps, prec: Precision):
    b, l, c = x.shape
    h = layer_norm(x, p, pre + "norm1", eps).reshape(b, res, res, c)
    if s:
        h = torch.roll(h, (-s, -s), (1, 2))
    nw = res // w
    h = h.reshape(b, nw, w, nw, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nw * nw, w * w, c)
    n, dk = w * w, c // heads
    qkv = prec.linear(h, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"])
    q, k, v = qkv.reshape(-1, n, 3, heads, dk).permute(2, 0, 3, 1, 4)
    att = prec.mm(q * dk**-0.5, k.transpose(-1, -2))
    table = p[pre + "attn.relative_position_bias_table"]
    att = att + table[rel_index(w, x.device).reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
    if s:
        att = (att.reshape(b, nw * nw, heads, n, n)
               + shift_mask(res, w, s, x.device)[None, :, None]).reshape(-1, heads, n, n)
    o = prec.mm(att.softmax(-1), v).transpose(1, 2).reshape(-1, n, c)
    o = prec.linear(o, p[pre + "attn.proj.weight"], p[pre + "attn.proj.bias"])
    o = o.reshape(b, nw, nw, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, res, res, c)
    if s:
        o = torch.roll(o, (s, s), (1, 2))
    x = x + o.reshape(b, l, c)
    m = layer_norm(x, p, pre + "norm2", eps)
    m = F.gelu(prec.linear(m, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"]))
    return x + prec.linear(m, p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"])


def swin(images: torch.Tensor, p: Dict[str, torch.Tensor], cfg: dict, prec: Precision,
         pre: str = "swin_transf.") -> torch.Tensor:
    """Normalized NHWC images -> (B, (img/32)^2, 8 * embed) features."""
    eps, ps, win = cfg["ln_eps"], cfg["patch_size"], cfg["window_size"]
    w = prec.q(p[pre + "patch_embed.proj.weight"])
    x = F.conv2d(prec.q(images.permute(0, 3, 1, 2)), w, p[pre + "patch_embed.proj.bias"],
                 stride=ps)
    x = layer_norm(x.flatten(2).transpose(1, 2), p, pre + "patch_embed.norm", eps)
    res = cfg["img_size"] // ps
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            w_eff = min(win, res)
            s = 0 if (j % 2 == 0 or res <= win) else win // 2
            x = swin_block(x, p, f"{pre}layers.{i}.blocks.{j}.", res, w_eff, s, heads, eps, prec)
        if i < len(cfg["depths"]) - 1:
            b, _, c = x.shape
            g = x.reshape(b, res, res, c)
            g = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2],
                           g[:, 1::2, 1::2]], -1).reshape(b, -1, 4 * c)
            g = layer_norm(g, p, f"{pre}layers.{i}.downsample.norm", eps)
            x = prec.linear(g, p[f"{pre}layers.{i}.downsample.reduction.weight"])
            res //= 2
    return layer_norm(x, p, pre + "norm", eps)


# ---------------------------------------------------------------------------
# ExpansionNet v2 caption head
# ---------------------------------------------------------------------------


def _l1(x, eps):
    return x / (x.sum(-1, keepdim=True) + eps)


def static_expansion(x, p, pre, groups: Sequence[int], eps, drop, rate, prec):
    """Block static expansion; x (B, S, d) -> (B, S, d) (no pad rows: the
    end-to-end model has none)."""
    d = x.shape[-1]
    q = p[pre + "query_exp_vectors.weight"]
    bias = p[pre + "bias_exp_vectors.weight"]
    key = prec.linear(x, p[pre + "key_embed.weight"], p[pre + "key_embed.bias"])
    z = drop(prec.mm(q, key.transpose(1, 2)) / math.sqrt(d), rate)  # (B, E, S)
    a, b = z.relu(), (-z).relu()
    ca = prec.linear(x, p[pre + "class_a_embed.weight"], p[pre + "class_a_embed.bias"])
    cb = prec.linear(x, p[pre + "class_b_embed.weight"], p[pre + "class_b_embed.bias"])
    ca = drop(prec.mm(_l1(a, eps), ca) + bias, rate)
    cb = drop(prec.mm(_l1(b, eps), cb) + bias, rate)
    zt = z.transpose(1, 2)

    def per_group(t):
        return torch.cat([_l1(u, eps) for u in t.split(list(groups), -1)], -1)

    ca = drop(prec.mm(per_group(zt.relu()), ca) / len(groups), rate)
    cb = drop(prec.mm(per_group((-zt).relu()), cb) / len(groups), rate)
    sel = torch.sigmoid(prec.linear(x, p[pre + "selector_embed.weight"],
                                    p[pre + "selector_embed.bias"]))
    return sel * ca + (1 - sel) * cb


def dynamic_expansion(x, p, pre, e, eps, causal, drop, rate, prec):
    """Block dynamic expansion over a whole prefix; causal (T, T) bool."""
    b, t, d = x.shape
    cond = prec.linear(x, p[pre + "cond_embed.weight"], p[pre + "cond_embed.bias"])[:, :, None]
    q = (p[pre + "query_exp_vectors.weight"] + cond).reshape(b, t * e, d)
    bias = (p[pre + "bias_exp_vectors.weight"] + cond).reshape(b, t * e, d)
    key = prec.linear(x, p[pre + "key_linear.weight"], p[pre + "key_linear.bias"])
    z = drop(prec.mm(q, key.transpose(1, 2)) / math.sqrt(d), rate)  # (B, T*e, T)
    rows = causal.repeat_interleave(e, 0)  # (T*e, T)
    ca = prec.linear(x, p[pre + "class_a_embed.weight"], p[pre + "class_a_embed.bias"])
    cb = prec.linear(x, p[pre + "class_b_embed.weight"], p[pre + "class_b_embed.bias"])
    ca = drop(prec.mm(_l1(z.relu() * rows, eps), ca), rate)
    cb = drop(prec.mm(_l1((-z).relu() * rows, eps), cb), rate)
    # the backward path: position t reads the expansions of positions <= t
    zt, cols = z.transpose(1, 2), causal.repeat_interleave(e, 1)  # (B, T, T*e)
    ca = drop(prec.mm(_l1(zt.relu() * cols, eps), ca + bias), rate)
    cb = drop(prec.mm(_l1((-zt).relu() * cols, eps), cb + bias), rate)
    sel = torch.sigmoid(prec.linear(x, p[pre + "selector_embed.weight"],
                                    p[pre + "selector_embed.bias"]))
    return sel * ca + (1 - sel) * cb


def attention(xq, xkv, p, pre, heads, prec):
    b, t, d = xq.shape
    dk = d // heads
    q = prec.linear(xq, p[pre + "Wq.weight"], p[pre + "Wq.bias"]).reshape(b, t, heads, dk)
    k = prec.linear(xkv, p[pre + "Wk.weight"], p[pre + "Wk.bias"]).reshape(b, -1, heads, dk)
    v = prec.linear(xkv, p[pre + "Wv.weight"], p[pre + "Wv.bias"]).reshape(b, -1, heads, dk)
    att = prec.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(dk)
    o = prec.mm(att.softmax(-1), v.transpose(1, 2)).transpose(1, 2).reshape(b, t, d)
    return prec.linear(o, p[pre + "out_linear.weight"], p[pre + "out_linear.bias"])


def feed_forward(x, p, pre, drop, rate, prec):
    h = drop(prec.linear(x, p[pre + "linear_1.weight"], p[pre + "linear_1.bias"]).relu(), rate)
    return prec.linear(h, p[pre + "linear_2.weight"], p[pre + "linear_2.bias"])


def caption_encoder(feats, p, cfg: dict, prec: Precision, drop: Drop) -> torch.Tensor:
    """Backbone features (B, S, F) -> encoder output (B, S, d)."""
    eps, ln, rate = cfg["eps"], cfg["ln_eps"], cfg["drop"]["enc"]
    x = drop(prec.linear(feats, p["input_linear.weight"], p["input_linear.bias"]),
             cfg["drop"]["enc_input"])
    outs: List[torch.Tensor] = []
    for i in range(cfg["N_enc"]):
        pre = f"encoders.{i}."
        h = static_expansion(layer_norm(x, p, pre + "norm_1", ln), p, pre + "stc_exp.",
                             cfg["num_exp_enc_list"], eps, drop, rate, prec)
        x = x + drop(h, rate)
        x = x + drop(feed_forward(layer_norm(x, p, pre + "norm_2", ln), p, pre + "ff.", drop,
                                  rate, prec), rate)
        outs.append(x)
    x = x + drop(prec.linear(torch.cat(outs, -1), p["enc_reduce_group.weight"],
                             p["enc_reduce_group.bias"]), cfg["drop"]["other"])
    return layer_norm(x, p, "enc_reduce_norm", ln)


def caption_decoder(cross, tokens, p, cfg: dict, prec: Precision, drop: Drop) -> torch.Tensor:
    """Teacher-forced decoder: cross (B, S, d), tokens (B, T) -> logits
    (B, T, V). Trailing pad tokens need no mask of their own: under the causal
    mask no real position reads a later one, so the logits of the real
    positions are those of the unpadded prefix."""
    b, t = tokens.shape
    d, eps, ln, rate = cfg["d_model"], cfg["eps"], cfg["ln_eps"], cfg["drop"]["dec"]
    ar = torch.arange(t, device=tokens.device)
    causal = ar[None, :] <= ar[:, None]  # (T, T)
    emb = p["out_embedder.embed.weight"][tokens.long().clamp(0, cfg["vocab_size"] - 1)]
    y = drop(emb, cfg["drop"]["dec_input"]) * math.sqrt(d) + p["pos_encoder.weight"][:t]
    outs = []
    for i in range(cfg["N_dec"]):
        pre = f"decoders.{i}."
        dyn = dynamic_expansion(layer_norm(y, p, pre + "norm_1", ln), p, pre + "dyn_exp.",
                                cfg["num_exp_dec"], eps, causal, drop, rate, prec)
        y = y + drop(dyn, rate)
        att = attention(layer_norm(y, p, pre + "norm_2", ln), cross, p, pre + "mha.",
                        cfg["num_heads"], prec)
        y = y + drop(att, rate)
        y = y + drop(feed_forward(layer_norm(y, p, pre + "norm_3", ln), p, pre + "ff.", drop,
                                  rate, prec), rate)
        outs.append(y)
    y = y + drop(prec.linear(torch.cat(outs, -1), p["dec_reduce_group.weight"],
                             p["dec_reduce_group.bias"]), cfg["drop"]["other"])
    y = layer_norm(y, p, "dec_reduce_norm", ln)
    return prec.linear(y, p["vocab_linear.weight"], p["vocab_linear.bias"])


def label_smoothing(logits, targets, pad, smoothing):
    """Sum over non-pad targets of KL(smoothed one-hot || softmax(logits))."""
    v = logits.shape[-1]
    logp = logits.float().log_softmax(-1)
    q = torch.full_like(logp, smoothing / (v - 1))
    q.scatter_(-1, targets.long()[..., None], 1.0 - smoothing)
    kl = (q * (q.log() - logp)).sum(-1)
    return torch.where(targets != pad, kl, 0.0).sum()
