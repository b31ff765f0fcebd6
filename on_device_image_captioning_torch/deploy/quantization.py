"""Int8 quantization of a model's linears (counterpart of the JAX package's
`deploy/quantization.py`).

Weights are quantized per output channel, symmetric: scale = max(max|w|,
1e-8) / 127, w_q = clip(rint(w / scale), -127, 127). A quantized linear is a
`QuantLinear` module in the place of the `nn.Linear` (or of the patch-embed
`Conv2d`, quantized as its (O, kh*kw*C) matrix in the (u, v, c) patch order,
which is the matrix the JAX package holds), and `models/common.py::linear`
dispatches on it, so every model and decode path runs quantized unchanged:

- "w8": weight-only. The weight is dequantized in bf16 (w_q.bf16 * scale.bf16)
  and x is rounded to bf16; the product sums in fp32 and its output stays
  fp32, whatever the model's compute dtype;
- "w8a8" (dynamic): x is quantized per tensor at run time by max|x| / 127 and
  the product is int8 x int8 with int32 accumulation, kernel B12
  (`ops/quant_matmul.py`); fp32 out;
- "w8a8_static": the same with activation scales frozen by `calibrate`.

Inside the window-resident Swin stages a block's linears do not run as
`QuantLinear`s: the attention half (and, under "w8", the MLP half or the whole
block) reads the weights dequantized in the compute dtype, and a w8a8 MLP half
runs kernel B13 with per-row int8 activations (`models/swin.py`), as the JAX
package routes them.

Module paths are this package's, i.e. the reference repo's
(`swin_transf.layers.0.blocks.1.attn.qkv`, `encoders.0.ff.linear_1`, ...); the
encoder / decoder filters select exactly the linears the JAX filters select in
its tree. `quantize_model` replaces modules in place and returns the model:
quantize before handing the model to `api.Captioner`, which lays out the
backbone's kernel operands once.
"""
from __future__ import annotations

import re
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.quant_matmul import QMAX, quantized_matmul

MODES = ("w8", "w8a8", "w8a8_static")
# the reference's encoder / decoder module-name filters, on this package's names
ENCODER_PAT = re.compile(r"(^|\.)(encoders|input_linear|enc_reduce_group|swin_transf)(\.|$)")
DECODER_PAT = re.compile(
    r"(^|\.)(decoders|vocab_linear|dec_reduce_group|out_embedder|pos_encoder)(\.|$)"
)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (out, in) -> (w_q int8 (out, in), scale fp32 (out,)): per output
    channel, the JAX package's `quantize_linear` exactly (fp32 division,
    round half to even)."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-8) / QMAX
    w_q = torch.round(w / scale[:, None]).clamp(-QMAX, QMAX).to(torch.int8)
    return w_q, scale


class QuantLinear(nn.Module):
    """An int8 linear: buffers `w_q` (out, in) int8, `scale` (out,) fp32,
    `bias` (out,) fp32 or None, `x_scale` a 0-d fp32 calibrated activation
    scale or None. `mode` is "w8" (weight-only) or "a8" (int8 activations).
    `conv` = (kernel, in_chans) marks the quantized patch-embed convolution.
    forward(x) returns fp32 (..., out)."""

    def __init__(self, out_features: int, in_features: int, bias: bool = True,
                 mode: str = "w8", static: bool = False, conv: Optional[Tuple[int, int]] = None):
        super().__init__()
        if mode not in ("w8", "a8"):
            raise ValueError(f"QuantLinear mode {mode!r}; expected 'w8' or 'a8'")
        self.mode = mode
        self.conv = None if conv is None else tuple(int(v) for v in conv)
        self.register_buffer("w_q", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones((out_features,)))
        self.register_buffer("bias", torch.zeros((out_features,)) if bias else None)
        self.register_buffer("x_scale", torch.ones(()) if static else None)

    @property
    def out_features(self) -> int:
        return self.w_q.shape[0]

    @classmethod
    def from_module(cls, module: nn.Module, mode: str) -> "QuantLinear":
        """Quantize an `nn.Linear`, or a patch-embed `nn.Conv2d` (stride ==
        kernel) as its (O, kh*kw*C) matrix in the (u, v, c) patch order."""
        conv = None
        w = module.weight.detach()
        if isinstance(module, nn.Conv2d):
            o, cin, kh, kw = w.shape
            if kh != kw or tuple(module.stride) != (kh, kw):
                raise ValueError("only the patch-embed convolution (stride == kernel) quantizes")
            w = w.permute(0, 2, 3, 1).reshape(o, -1)
            conv = (kh, cin)
        q = cls(w.shape[0], w.shape[1], module.bias is not None,
                "a8" if mode.startswith("w8a8") else "w8", conv=conv)
        w_q, scale = quantize_weight(w)
        q.to(w.device)
        q.w_q.copy_(w_q)
        q.scale.copy_(scale)
        if module.bias is not None:
            q.bias.copy_(module.bias.detach().float())
        return q

    def dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        """(out, in) weight w_q * scale formed in `dtype` (the JAX package's
        `_weight` for the kernels' operands; bf16 is the "w8" product's)."""
        return self.w_q.to(dtype) * self.scale.to(dtype)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "w8":
            # bf16 operands, exact products summed in fp32, output not rounded
            y = torch.matmul(x.to(torch.bfloat16).float(), self.dequantized(torch.bfloat16).float().t())
            return y if self.bias is None else y + self.bias
        return quantized_matmul(x, self.w_q, self.scale, self.bias, self.x_scale)

    def get_extra_state(self):
        return {"mode": self.mode, "conv": self.conv}

    def set_extra_state(self, state) -> None:
        self.mode = state["mode"]
        self.conv = None if state.get("conv") is None else tuple(state["conv"])

    def extra_repr(self) -> str:
        out, inp = self.w_q.shape
        return f"in={inp}, out={out}, mode={self.mode}, bias={self.bias is not None}"


def is_a8(module: nn.Module) -> bool:
    return isinstance(module, QuantLinear) and module.mode == "a8"


def _set_module(model: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, module)


def quantize_model(model: nn.Module, mode: str = "w8",
                   path_filter: Optional[Callable[[str], bool]] = None) -> nn.Module:
    """Replace every `nn.Linear` (and the patch-embed convolution) whose module
    path passes the filter by a `QuantLinear` of `mode` ("w8", "w8a8" or
    "w8a8_static"), in place. Embeddings and LayerNorms stay fp32; linears
    already quantized stay as they are. Returns the model."""
    if mode not in MODES:
        raise ValueError(f"quantization mode {mode!r}; expected one of {MODES}")
    targets = [(name, m) for name, m in model.named_modules()
               if isinstance(m, (nn.Linear, nn.Conv2d)) and (path_filter is None or path_filter(name))]
    for name, module in targets:
        _set_module(model, name, QuantLinear.from_module(module, mode))
    return model


def quantize_encoder(model: nn.Module, mode: str = "w8") -> nn.Module:
    """Quantize the encoder half (the backbone and the caption encoder)."""
    return quantize_model(model, mode, lambda p: bool(ENCODER_PAT.search(p)))


def quantize_decoder(model: nn.Module, mode: str = "w8") -> nn.Module:
    return quantize_model(model, mode, lambda p: bool(DECODER_PAT.search(p)))


def dequantize_model(model: nn.Module) -> nn.Module:
    """Expand every weight-only ("w8") `QuantLinear` back into a dense module
    holding the bf16 dequantized weight (in fp32 storage: the same numbers as
    the JAX package's bf16 `w`); int8-activation ("a8") linears stay. In
    place; returns the model."""
    targets = [(name, m) for name, m in model.named_modules()
               if isinstance(m, QuantLinear) and m.mode == "w8"]
    for name, q in targets:
        w = q.dequantized(torch.bfloat16).float()
        out, inp = w.shape
        if q.conv is not None:
            k, cin = q.conv
            dense = nn.Conv2d(cin, out, kernel_size=k, stride=k, bias=q.bias is not None)
            w = w.reshape(out, k, k, cin).permute(0, 3, 1, 2)
        else:
            dense = nn.Linear(inp, out, bias=q.bias is not None)
        dense.to(w.device)
        with torch.no_grad():
            dense.weight.copy_(w)
            if q.bias is not None:
                dense.bias.copy_(q.bias)
        _set_module(model, name, dense)
    return model


def calibrate(model: nn.Module, collect: Iterable[Tuple[str, float]]) -> nn.Module:
    """Static activation calibration: `collect` holds (module path, absmax of
    that linear's input) pairs recorded over calibration batches; each
    quantized linear named there gets x_scale = max(amax, 1e-8) / 127 (the
    largest amax recorded for it) and int8 activations. In place; returns the
    model."""
    scales = {}
    for path, amax in collect:
        scales[path] = max(scales.get(path, 0.0), float(amax))
    for name, module in model.named_modules():
        if isinstance(module, QuantLinear) and name in scales:
            value = np.float32(max(scales[name], 1e-8) / 127.0)
            module.x_scale = torch.tensor(value, device=module.w_q.device)
            module.mode = "a8"
    return model


def fake_quant(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Differentiable fake quantization for quantization-aware training: the
    per-tensor int8 round trip forward, the identity backward (straight-through
    estimator)."""
    qmax = 2.0 ** (num_bits - 1) - 1
    scale = torch.clamp(x.abs().amax(), min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return x + (q - x).detach()


def quantized_size_bytes(model: nn.Module) -> int:
    """Serialized parameter footprint: every tensor of the state_dict, int8
    weights at one byte."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values()
               if isinstance(t, torch.Tensor))


def load_quantized_state_dict(model: nn.Module, sd) -> nn.Module:
    """Load a state_dict that holds quantized linears (keys `<path>.w_q`, as
    `model.state_dict()` of a quantized model or `params/convert.py::
    state_dict_from_jax` of a quantized JAX tree give them): each such path
    becomes a `QuantLinear` of the stored shape, mode and buffers, then the
    whole state_dict loads strictly."""
    for key in [k for k in sd if k.endswith(".w_q")]:
        name = key[: -len(".w_q")]
        extra = sd.get(name + "._extra_state", {"mode": "w8", "conv": None})
        out, inp = sd[key].shape
        q = QuantLinear(out, inp, name + ".bias" in sd, extra["mode"], name + ".x_scale" in sd,
                        extra.get("conv"))
        _set_module(model, name, q)
    model.load_state_dict(sd, strict=True)
    return model
