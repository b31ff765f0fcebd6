"""The fixed-shape caption engine: an exported, serialized image-to-tokens
program (counterpart of the JAX package's `deploy/aot.py`; reference
onnx4tensorrt/convert2onnx.py:143-265, onnx2tensorrt.py:44-203).

- `caption_fn` is the computation: uint8 images -> normalization on the
  device -> encoder -> beam search for a fixed number of steps, the caches
  grown at each boundary of the decode config's chunk schedule
  (`decode/beam_search.py::fixed_beam_search`, the reference's unrolled
  decoder with beams; greedy is beam 1) -> (tokens, lengths) of the best
  beam;
- `build_caption_engine` exports it with `torch.export` for one batch shape;
- `export_artifact` / `load_artifact` write and read the program
  (`graph.pt2`, `torch.export.save`) and `manifest.json`, so that a serving
  process needs neither `models/` nor `decode/`: only the kernels' sources
  and their registration (`ops/`), which `load_artifact` imports.

Every kernel is a `torch.library` op of the namespace `odic` (`ops/_build.py
::define_op`), so the program holds them as calls, each dispatched by
device when the program runs: the hand-written kernels on the card, their
plain versions on the CPU.

Weights. The program holds each weight once, in the dtype it ships in
(`param_dtype`), and casts it in the graph to the dtype the model code reads
(fp32 masters, as the eager model keeps them). The layouts that
`prepare_inference` keeps beside the weights (the block kernels' (in, out)
matrices, the expanded relative-position biases, the fused step's cross
operands) are made in the graph on every call, not shipped: a copy of the
backbone's weights a call, for an artifact of one copy of them.

What the engine is for: the self-contained artifact, not speed. The loaded
`ExportedProgram.module()` runs its calls one by one from Python, as the
eager model does, plus the casts and layouts above; CUDA graphs over it
wait for ROADMAP B-6c, and AOTInductor is not used (it would need C++
registrations of the kernels).
"""
from __future__ import annotations

import copy
import json
import os
import zipfile
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import DecodeConfig, ModelConfig

GRAPH = "graph.pt2"
MANIFEST = "manifest.json"
# the modules whose import registers every `odic` op
OP_MODULES = ("dyn_exp_step", "fused_linear", "layernorm", "quant_matmul", "stage_boundary",
              "swin_block_fused", "topk", "window_attention")


def register_ops() -> None:
    """Import the `ops/` modules, which define the `odic` ops (nothing is
    built: the kernels compile at their first launch)."""
    import importlib

    for name in OP_MODULES:
        importlib.import_module(f"{__package__.rpartition('.')[0]}.ops.{name}")


def caption_fn(cfg: ModelConfig, dcfg: DecodeConfig, greedy: bool = False,
               step_impl: str = "pallas") -> Callable:
    """The fixed-shape captioning computation: fn(model, images_u8) ->
    (tokens (B, L) int32, lengths (B,) int32) of the best beam, over an
    `EndExpansionNetV2` on the images' device. greedy=True decodes beam 1
    (the export path's greedy decoder)."""
    from ..decode import beam_search as bs
    from ..utils.image import normalize_on_device

    use_dcfg = (
        DecodeConfig(beam_size=1, how_many_outputs=1, max_seq_len=dcfg.max_seq_len,
                     sos_idx=dcfg.sos_idx, eos_idx=dcfg.eos_idx,
                     chunk_schedule=dcfg.chunk_schedule)
        if greedy else dcfg
    )

    def fn(model, images_u8):
        x = normalize_on_device(images_u8)
        enc = model.forward_enc(x)
        res = bs.fixed_beam_search(model, cfg.captioner, enc, use_dcfg, dtype=cfg.compute_dtype,
                                   step_impl=step_impl)
        return res.tokens[:, 0], res.lengths[:, 0]

    return fn


class _Run(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, images_u8: torch.Tensor):
        return self.fn(self.model, images_u8)


class _Engine(nn.Module):
    """The exported module: the model's weights in their shipped dtype, cast
    in the graph to fp32 (every floating weight; int8 and index tensors as
    they are) before the model code reads them."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.run = _Run(model, fn)

    def forward(self, images_u8: torch.Tensor):
        model = self.run.model
        state = {f"model.{name}": t.float()
                 for name, t in (*model.named_parameters(), *model.named_buffers())
                 if t.is_floating_point() and t.dtype != torch.float32}
        return torch.func.functional_call(self.run, state, (images_u8,))


def _target_dtype(cfg: ModelConfig, param_dtype: str) -> Optional[torch.dtype]:
    if param_dtype == "auto":
        return cfg.compute_dtype
    if param_dtype == "stored":
        return None
    dtype = getattr(torch, param_dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"param_dtype {param_dtype!r}: 'auto', 'stored' or a float dtype name")
    return dtype


def _shipped(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """A copy of the model without the layouts `prepare_inference` keeps
    (they are made in the graph), every floating weight in `dtype` (None:
    each as stored)."""
    model = copy.deepcopy(model).eval()
    for module in model.modules():
        if getattr(module, "fused_cache", None) is not None:
            module.fused_cache = None
        if getattr(module, "rel_bias_x", None) is not None:
            module.rel_bias_x = None
        module.__dict__.pop("_cross_operands", None)
    if dtype is not None:
        stored = model.state_dict(keep_vars=True)
        for t in stored.values():
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                t.data = t.data.to(dtype)
    return model


@torch.no_grad()
def round_to_shipped(model: nn.Module, cfg: ModelConfig, param_dtype: str = "auto") -> nn.Module:
    """Round the model's floating weights, in place, through the dtype an
    artifact of `param_dtype` ships them in (they stay in their own dtype):
    the eager model that computes what the loaded artifact computes."""
    dtype = _target_dtype(cfg, param_dtype)
    if dtype is not None:
        for t in model.state_dict(keep_vars=True).values():
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                t.copy_(t.to(dtype))
    return model


def _export(model: nn.Module, cfg: ModelConfig, dcfg: DecodeConfig, batch_size: int,
            greedy: bool, step_impl: str, dtype: Optional[torch.dtype]):
    device = next(model.parameters()).device
    engine = _Engine(_shipped(model, dtype), caption_fn(cfg, dcfg, greedy, step_impl))
    images = torch.zeros((batch_size, cfg.swin.img_size, cfg.swin.img_size, 3), dtype=torch.uint8,
                         device=device)
    with torch.no_grad():
        return torch.export.export(engine, (images,), strict=False)


def build_caption_engine(
    model: nn.Module, cfg: ModelConfig, dcfg: DecodeConfig, batch_size: int,
    greedy: bool = False, step_impl: str = "pallas",
) -> Tuple[Callable, Dict]:
    """Export the engine for exactly this batch shape on the model's device,
    over the weights as stored. Returns (engine, cost): engine(images_u8)
    -> (tokens (B, L), lengths (B,)), run under inference mode; cost is {}
    (the FLOP count is `deploy/analysis.py`'s, not ported yet)."""
    module = _export(model, cfg, dcfg, batch_size, greedy, step_impl, None).module()

    @torch.inference_mode()
    def engine(images_u8):
        return module(images_u8)

    return engine, {}


def export_artifact(
    path: str, model: nn.Module, cfg: ModelConfig, dcfg: DecodeConfig, batch_size: int,
    greedy: bool = False, param_dtype: str = "auto", step_impl: str = "pallas",
) -> None:
    """Write the deployable artifact: `graph.pt2` (the exported program and
    its weights, `torch.export.save`) and `manifest.json`.

    param_dtype: the dtype floating weights SHIP in: "auto" (default) the
    model's compute dtype, so a bf16 engine ships bf16 weights; "stored"
    each tensor's own dtype; or a dtype name ("bfloat16", "float32", ...).
    Int8 weights and index tables keep their dtype. The program is traced
    over the shipped weights, so loading and running it gives what the model
    gives on those weights (rounded through the shipped dtype)."""
    from ..decode.beam_search import schedule_of

    tgt = _target_dtype(cfg, param_dtype)
    ep = _export(model, cfg, dcfg, batch_size, greedy, step_impl, tgt)
    os.makedirs(path, exist_ok=True)
    torch.export.save(ep, os.path.join(path, GRAPH))
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(
            {
                "param_dtype": "stored" if tgt is None else str(tgt).removeprefix("torch."),
                "batch_size": batch_size,
                "img_size": cfg.swin.img_size,
                "beam_size": 1 if greedy else dcfg.beam_size,
                "max_seq_len": dcfg.max_seq_len,
                "chunk_schedule": list(schedule_of(dcfg)),
                "step_impl": step_impl,
                "attention_impl": cfg.swin.attention_impl,
            },
            f,
        )


def load_manifest(path: str) -> dict:
    """The artifact's manifest (weight dtype and engine shape); {} where
    there is none."""
    p = os.path.join(path, MANIFEST)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def weight_bytes(path: str) -> int:
    """Bytes of the weights and constants stored in the artifact's program
    (its archive's data entries, uncompressed)."""
    with zipfile.ZipFile(os.path.join(path, GRAPH)) as z:
        return sum(i.file_size for i in z.infolist() if "/data/" in i.filename)


def load_artifact(path: str) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """Load an artifact: returns (call, params) where call(params, images_u8)
    runs the engine on those weights under inference mode
    (`torch.func.functional_call` over the loaded program's module). Needs the `odic` ops registered, which it does
    first; nothing of `models/` or `decode/` is imported."""
    register_ops()
    module = torch.export.load(os.path.join(path, GRAPH)).module()
    params = {**dict(module.named_parameters()), **dict(module.named_buffers())}

    @torch.inference_mode()
    def call(params, images_u8):
        return torch.func.functional_call(module, params, (images_u8,))

    return call, params
