#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`on_device_image_captioning_torch`) on one
NVIDIA card: the quickest proof that the port builds, is right and runs.

    python3 chip_smoke.py [kernel ...]

With kernel names (keys of KERNELS, e.g. `swin_attn_bwd swin_mlp_bwd`) only
phases 1-3 and the kernels' part of phase 6 run, for those kernels, and no
result line is printed: the quick check while working on a kernel.

Phases, in order (any failure raises and exits non-zero before the result):

1. Device: card name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compile every kernel of the main path from the sources in the
   checkout (CUDA through nvcc, all sources at once; Triton through its JIT)
   and print the seconds.
3. Each kernel against its plain PyTorch version on the card, at main-path
   shapes, in fp32 and bf16, with the tolerance printed beside each check.
4. Main path at full width, once per run of RUNS: the `attention_impl`
   "pallas" backbone; the "fused" backbone with its default stage modes (the
   whole-block kernel at stages 0 and 1) and the "pallas_fused" decode step;
   the "fused" backbone with every stage on the half-block kernels. Each is
   Swin-L/384 + the d512 captioner, V = 10000, seeded random weights,
   `api.Captioner` beam search on 8 uint8 images at 384^2, beam 3,
   max_seq_len 20, bf16. The launch counters are set to 0 before each run
   and read after it; every kernel of that run must have been launched and
   no other, the window-resident kernels exactly as often as the model has
   blocks and stages, the decode-step kernels once per layer and step. The
   runs' encoder outputs must agree within the bf16 tolerance. Then a
   sampling run (8 images x 5 samples, 20 tokens) and a two-model ensemble
   run on the same path, checked for shape.
   Quantized serving (runs of QUANT_RUNS): the "fused" model with every
   linear quantized by `deploy/quantization.py::quantize_model`, as
   `--quantize` does in the JAX package's evaluate CLI: "w8a8" (int8
   activations; the "pallas" step) and "w8" (weight-only; the "pallas_fused"
   step, which gives way to K2 on a quantized Wq), b8 / beam 3 / L20, bf16.
   The model's bytes before and after; the launches of each kernel in the
   beam search and in one encode, held exactly to the counts derived from
   the model (B12 once per int8 linear outside the window-resident stages
   per encode, once per int8 linear of the decoder per step and for the
   cross K/V once; B13 and B4 once per w8a8 block; B5, B6, B7, B8, B16 not at
   all under w8a8).
   Training (run "train"): Swin-L/384 + the d512 captioner on the "fused"
   path at full width and depth, bf16 compute over fp32 master weights, 4
   images, stochastic depth 0.1, caption-head dropouts 0.1, captions of 20
   random ids, `train/train_step.py::make_xe_step` with PlainRAdam (RAdam
   with its SGD fallback: plain RAdam takes no step at all before its
   fifth), four steps on one batch. The loss must be finite at every step
   and lower at the last than at the first, every parameter must have a
   finite gradient, and in every step each training kernel must have been
   launched exactly as often as the model has blocks (the counters are set
   to 0 before each step and read after it).
5. The runs held to the plain path: 2 images at fp32 through each run on the
   card and through the plain path on the CPU, same weights; then sampling
   and the ensemble, card against CPU with the same noise, and the two
   decode-step paths against each other. The quantized runs: 2 images at
   fp32 through the w8a8 and w8 models on the card and on the CPU's plain
   path, same quantized weights. Per-tensor int8 activations make the
   full-depth model chaotic: a 1e-7 change of the input moves the encoder
   output by percents on the CPU alone (the int8 roundings downstream of a
   shifted tensor maximum all shift; under w8 the bf16 roundings of the
   activations do the same, more weakly). So each module of the encoder is
   held on the CPU's input to it (1e-2 of its max, 1e-3 of its RMS); the
   free-running encoder output may depart from the CPU's no more than 5
   times as far as the CPU's own output does when the patch embed's
   LayerNorm scale is nudged by 1e-7; the decode of the CPU's encoder
   output gives the CPU's tokens
   under the margin rule (near-ties up to 2e-2: int8 noise).
   Training held to the plain path: fp32, depths cut to (2, 2, 2, 2) at full
   width, 2 images, no dropout, the same stochastic-depth scales: loss and
   every gradient of the kernel path on the card against the plain path on
   the CPU; then once more with the CPU's ReLU signs imposed on the card's
   caption head, which holds every gradient to a quarter of the backbone's
   tolerance.
6. Times: each kernel against its plain version, its bound (the least time
   the card could take, from the case's bytes and operations) and, where one
   PyTorch call computes the same function, that call (CUDA events); encode
   ms of the three backbone forms; decode ms per step of both step paths;
   end-to-end img/s at b8/beam 3/L20 and p50 latency at b1/beam 5/L74, bf16,
   on the default path; encode ms of the w8a8 model against the "fused"
   bf16 one in turns, its decode ms per step and img/s at b8; ms per XE step at b4 bf16 with its split into
   forward, backward and optimizer, and the step's peak device memory.

The next-to-last line is {"kernels": [...]} and the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BEAM_SERVE, L_SERVE, B_SERVE = 3, 20, 8
BEAM_LAT, L_LAT = 5, 74
N_SAMPLES = 5
N_DEC = 3  # decoder layers of the d512 captioner
# main-path runs: name -> (attention_impl, every stage on the halves?, step_impl)
RUNS = {
    "pallas": ("pallas", False, "pallas"),
    "fused": ("fused", False, "pallas_fused"),
    "fused_halves": ("fused", True, "pallas"),
}
ALL_RUNS = tuple(RUNS)
WINDOW_RUNS = ("fused", "fused_halves")
TRAIN = "train"  # the training run of phase 4: XE steps on the "fused" path
# quantized serving runs on the "fused" path: name -> (quantize_model mode, step_impl)
QUANT_RUNS = {"w8a8": ("w8a8", "pallas"), "w8": ("w8", "pallas_fused")}
Q_RUNS = tuple(QUANT_RUNS)
B_TRAIN, L_TRAIN, TRAIN_STEPS, TRAIN_LR = 4, 20, 4, 2e-3
# published peaks of one H100 SXM (dense): device memory bytes/s; bf16 matrix
# products on the tensor cores; fp32 outside them
HBM_BYTES_S, BF16_FLOPS, FP32_FLOPS, INT8_OPS = 3.35e12, 989e12, 67e12, 1979e12
_TPU = "on_device_image_captioning_tpu/ops/"
_PORT = "on_device_image_captioning_torch/"
# kernel -> route, source, the TPU kernel it replaces, (ops module, launch
# counter), the runs that launch it, and the phase-6 case whose times go into
# the {"kernels": ...} line
KERNELS = {
    "window_attention": dict(
        route="cuda", source=_PORT + "csrc/window_attention.cu",
        replaces=_TPU + "window_attention.py:55", counter=("window_attention", "launches"),
        paths=ALL_RUNS + Q_RUNS, headline="stage0 qkv(128, 144, 576) H6 mask bfloat16"),
    "dyn_exp_step": dict(
        route="cuda", source=_PORT + "csrc/dyn_exp_step.cu",
        replaces=_TPU + "dyn_exp_step.py:226", counter=("dyn_exp_step", "launches"),
        paths=("pallas", "fused_halves") + Q_RUNS, headline="B24 L20 pos7 bfloat16"),
    "topk": dict(
        route="cuda", source=_PORT + "csrc/topk.cu",
        replaces=_TPU + "topk.py:78", counter=("topk", "launches"),
        paths=ALL_RUNS + Q_RUNS, headline="R24 V10000 k3 float32"),
    "layernorm": dict(
        route="triton", source=_PORT + "ops/layernorm.py",
        replaces=_TPU + "layernorm.py:36", counter=("layernorm", "launches"),
        paths=ALL_RUNS + (TRAIN,) + Q_RUNS, headline="(18432, 192) bfloat16"),
    "patch_embed": dict(
        route="cuda", source=_PORT + "csrc/stage_boundary.cu",
        replaces=_TPU + "stage_boundary.py:100",
        counter=("stage_boundary", "patch_embed_launches"),
        paths=WINDOW_RUNS, headline="x(2, 96, 96, 48) C192 bfloat16"),
    "downsample": dict(
        route="cuda", source=_PORT + "csrc/stage_boundary.cu",
        replaces=_TPU + "stage_boundary.py:179",
        counter=("stage_boundary", "downsample_launches"),
        paths=WINDOW_RUNS, headline="stage0 x(128, 144, 192) bfloat16"),
    "swin_attn_half": dict(
        route="cuda", source=_PORT + "csrc/swin_attn_half.cu",
        replaces=_TPU + "swin_block_fused.py:872",
        counter=("swin_block_fused", "attn_half_launches"),
        paths=WINDOW_RUNS + Q_RUNS, headline="stage2 x(8, 144, 768) mask trans0to6 bfloat16"),
    "swin_mlp_half": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_half.cu",
        replaces=_TPU + "swin_block_fused.py:1113",
        counter=("swin_block_fused", "mlp_half_launches"),
        paths=WINDOW_RUNS + ("w8",), headline="stage2 x(8, 144, 768) bfloat16"),
    "window_transition": dict(
        route="cuda", source=_PORT + "csrc/window_transition.cu",
        replaces=_TPU + "swin_block_fused.py:625",
        counter=("swin_block_fused", "transition_launches"),
        paths=WINDOW_RUNS + (TRAIN,) + Q_RUNS, headline="stage0 x(128, 144, 192) 6to0 bfloat16"),
    "swin_block": dict(
        route="cuda", source=_PORT + "csrc/swin_block.cu",
        replaces=_TPU + "swin_block_fused.py:677",
        counter=("swin_block_fused", "block_launches"),
        paths=("fused", "w8"), headline="stage0 x(128, 144, 192) mask trans0to6 bfloat16"),
    "dyn_exp_cross_step": dict(
        route="cuda", source=_PORT + "csrc/dyn_exp_step.cu",
        replaces=_TPU + "dyn_exp_step.py:502",
        counter=("dyn_exp_step", "cross_launches"),
        paths=("fused",), headline="B24 L20 pos7 bfloat16"),
    "swin_block_train": dict(
        route="cuda", source=_PORT + "csrc/swin_block.cu",
        replaces=_TPU + "swin_block_fused.py:1285",
        counter=("swin_block_fused", "block_train_launches"),
        paths=(TRAIN,), headline="stage0 x(128, 144, 192) mask bfloat16"),
    "swin_attn_bwd": dict(
        route="cuda", source=_PORT + "csrc/swin_attn_bwd.cu",
        replaces=_TPU + "swin_block_fused.py:2063",
        counter=("swin_block_fused", "attn_bwd_launches"),
        paths=(TRAIN,), headline="stage0 x(128, 144, 192) mask bfloat16"),
    "swin_mlp_bwd": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_bwd.cu",
        replaces=_TPU + "swin_block_fused.py:1547",
        counter=("swin_block_fused", "mlp_bwd_launches"),
        paths=(TRAIN,), headline="stage0 x(128, 144, 192) bfloat16"),
    "swin_attn_half_train": dict(
        route="cuda", source=_PORT + "csrc/swin_attn_half.cu",
        replaces=_TPU + "swin_block_fused.py:2274",
        counter=("swin_block_fused", "attn_half_train_launches"),
        paths=(TRAIN,), headline="stage2 x(8, 144, 768) mask bfloat16"),
    "swin_mlp_half_train": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_half.cu",
        replaces=_TPU + "swin_block_fused.py:2396",
        counter=("swin_block_fused", "mlp_half_train_launches"),
        paths=(TRAIN,), headline="stage2 x(8, 144, 768) bfloat16"),
    "quant_matmul": dict(
        route="cuda", source=_PORT + "csrc/quant_matmul.cu",
        replaces=_TPU + "quant_matmul.py:48", counter=("quant_matmul", "launches"),
        paths=("w8a8",), headline="stage3 fc1 x(288, 1536) N6144 float32"),
    "swin_mlp_half_a8": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_half_a8.cu",
        replaces=_TPU + "swin_block_fused.py:1076",
        counter=("swin_block_fused", "mlp_half_a8_launches"),
        paths=("w8a8",), headline="stage2 x(8, 144, 768) bfloat16"),
}
# launches of the training kernels in one XE step of Swin-L (depths 2, 2, 18,
# 2): the whole-block forward at stages 0 and 1, the two half forwards at
# stage 2, both backwards once per block of stages 0-2, and a transition
# before every shifted block and after it, forward and backward
TRAIN_LAUNCHES = {"swin_block_train": 4, "swin_attn_half_train": 18, "swin_mlp_half_train": 18,
                  "swin_attn_bwd": 22, "swin_mlp_bwd": 22, "window_transition": 44}
# launches of the window-resident kernels in one encode of Swin-L (depths
# 2, 2, 18, 2): one per block of stages 0-2 (the whole-block kernel at stages
# 0 and 1 unless every stage is on the halves), one per stage boundary, and
# the two single-window blocks of stage 3 on the attention-core kernel
ENCODE_LAUNCHES = {
    "fused": {"patch_embed": 1, "downsample": 3, "swin_block": 4, "swin_attn_half": 18,
              "swin_mlp_half": 18, "window_transition": 3, "window_attention": 2},
    "fused_halves": {"patch_embed": 1, "downsample": 3, "swin_block": 0, "swin_attn_half": 22,
                     "swin_mlp_half": 22, "window_transition": 3, "window_attention": 2},
}
# launches of the decode-step kernels in one b8 / beam 3 / L20 decode: one per
# decoder layer and step (random weights emit no EOS: L - 1 steps)
DECODE_LAUNCHES = {
    "pallas": {"dyn_exp_step": N_DEC * (L_SERVE - 1), "dyn_exp_cross_step": 0},
    "pallas_fused": {"dyn_exp_step": 0, "dyn_exp_cross_step": N_DEC * (L_SERVE - 1)},
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.card = ""
        self.errors = {k: 0.0 for k in KERNELS}
        self.times = {}
        self.launches = {}  # run -> kernel -> launches in that main-path run
        self.serve = {}  # run -> bf16 Captioner at b8 / beam 3 / L20
        self.trainer = None  # (cfg, model, optimizer, step, batch, generator) of the training run

    # -- helpers -------------------------------------------------------------
    def check(self, case) -> None:
        """Hold one phase-3 case's kernel against its plain version."""
        from on_device_image_captioning_torch.ops import _cases

        for part, got, want, tol in case.check():
            abs_err, rel_err, ok = _cases.compare(got, want, tol)
            if "int8" not in part:  # int8 parts count codes and steps, not errors of values
                self.errors[case.kernel] = max(self.errors[case.kernel], abs_err)
            log(f"  [{'ok' if ok else 'FAIL'}] {case.kernel} {case.label} {part}: "
                f"max_abs={abs_err:.3e} max_rel={rel_err:.3e} "
                f"tol=atol {tol[0]:g} + rtol {tol[1]:g}")
            if not ok:
                raise AssertionError(
                    f"{case.kernel} {case.label} {part} disagrees with its plain version")

    def cuda_time(self, fn, iters=20, warmup=3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def counters(self, reset=False):
        """Every kernel's launch counter; reset=True sets them all to 0."""
        import importlib

        out = {}
        for name, k in KERNELS.items():
            mod = importlib.import_module(
                "on_device_image_captioning_torch.ops." + k["counter"][0])
            if reset:
                setattr(mod, k["counter"][1], 0)
            out[name] = getattr(mod, k["counter"][1])
        return out

    def library_call(self, case):
        """One PyTorch call that computes the case's function on the same
        tensors, as a yardstick of speed (the port never calls it); None
        where no single call does."""
        torch = self.torch
        F = torch.nn.functional
        if case.kernel == "window_attention":
            qkv, bias, mask, heads, scale = case.args
            bw, n, c3 = qkv.shape
            q, k, v = qkv.reshape(bw, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
            add = bias[None]
            if mask is not None:  # the additive bias + mask, (BW, H, N, N)
                nw = mask.shape[0]
                add = (bias[None, None] + mask[None, :, None]).expand(
                    bw // nw, nw, heads, n, n).reshape(bw, heads, n, n)
            add = add.to(qkv.dtype)
            return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=scale)
        if case.kernel == "topk":
            x, k = case.args
            return lambda: torch.topk(x, k)
        if case.kernel == "layernorm":
            x, w, b = case.args
            w, b = w.to(x.dtype), b.to(x.dtype)
            return lambda: F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)
        if case.kernel == "quant_matmul":
            # the int8 product alone, on operands quantized beforehand
            from on_device_image_captioning_torch.ops import quant_matmul as qm

            x, w_q, _, _, x_scale = case.args
            xq = qm.quantize(x, qm.dynamic_scale(x) if x_scale is None else x_scale)
            w_t = w_q.t()
            try:
                torch._int_mm(xq, w_t)
            except RuntimeError as err:  # a yardstick only: report, do not fail
                log(f"  torch._int_mm refused {case.label}: {str(err).splitlines()[0]}")
                return None
            return lambda: torch._int_mm(xq, w_t)
        if case.kernel == "window_transition":
            from on_device_image_captioning_torch.ops.window_layout import window_transition_perm

            x, res, window, f, t = case.args
            perm = torch.from_numpy(window_transition_perm(res, window, f, t)).to(x.device)
            flat = x.reshape(-1, res * res, x.shape[-1])
            return lambda: torch.index_select(flat, 1, perm)
        return None

    # -- phase 1 ---------------------------------------------------------------
    def device(self):
        torch = self.torch
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        self.card = smi
        log(smi)
        log(f"phase 1 device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
            f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- phase 2 ---------------------------------------------------------------
    def build(self):
        torch = self.torch
        from on_device_image_captioning_torch.ops import _build, layernorm

        start = time.perf_counter()
        _build.compile_all()
        for src in sorted(_build.CSRC_DIR.glob("*.cu")):
            _build.load_cuda_library(src.stem)
        x = torch.ones((4, 192), device=self.dev)
        layernorm.layernorm(x, torch.ones(192, device=self.dev), torch.zeros(192, device=self.dev))
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        per = ", ".join(f"{k} {v:.1f}s" for k, v in _build.build_seconds.items())
        log(f"phase 2 build: {total:.1f}s in all (nvcc, all sources at once: {per}; "
            f"the rest is the Triton JIT)")

    # -- phase 3 ---------------------------------------------------------------
    def kernels(self, names=None):
        torch = self.torch
        from on_device_image_captioning_torch.ops import _cases

        log("phase 3 kernels against their plain versions (on the card; "
            "cases and tolerances from ops/_cases.py)")
        for name in names or _cases.CASES:
            for case in _cases.CASES[name](self.dev):
                self.check(case)
        torch.cuda.synchronize()

    # -- models ------------------------------------------------------------------
    def model(self, dtype, device, run="pallas", seed=SEED):
        """(cfg, model, step_impl) of a main-path run, seeded random weights."""
        import dataclasses

        torch = self.torch
        from on_device_image_captioning_torch.config import end_expansionnet_v2_coco
        from on_device_image_captioning_torch.models.end_to_end import (
            EndExpansionNetV2, init_weights,
        )

        path, halves, step_impl = RUNS[run]
        cfg = end_expansionnet_v2_coco(compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, attention_impl=path))
        modes = {i: "halves" for i in range(cfg.swin.num_layers)} if halves else None
        model = EndExpansionNetV2(cfg, modes)
        init_weights(model, torch.Generator().manual_seed(seed))
        return cfg, model.to(device), step_impl

    def quant_model(self, dtype, device, mode, seed=SEED):
        """(cfg, model) of a quantized run: the "fused" model of run "fused"
        with every linear quantized (`quantize_model`), built on the CPU and
        then moved, so the card and the CPU hold the same int8 weights."""
        from on_device_image_captioning_torch.deploy.quantization import (
            quantize_model, quantized_size_bytes,
        )

        cfg, model, _ = self.model(dtype, "cpu", "fused", seed)
        before = quantized_size_bytes(model)
        quantize_model(model, mode)
        return cfg, model.to(device), (before, quantized_size_bytes(model))

    def quant_launches(self, model, steps):
        """The launches one encode and one decode of `steps` steps must make,
        derived from the quantized model: (encode counts, decode counts)."""
        from on_device_image_captioning_torch.deploy.quantization import is_a8

        swin = model.swin_transf
        multi = [l for l in swin.layers if l.blocks[0].res > l.blocks[0].window]
        single = [b for l in swin.layers if l not in multi for b in l.blocks]
        blocks = [b for l in multi for b in l.blocks]
        b12 = is_a8(swin.patch_embed.proj) + sum(
            is_a8(l.downsample.reduction) for l in swin.layers if l.downsample is not None)
        b12 += sum(is_a8(m) for b in single for m in (b.attn.qkv, b.attn.proj, b.mlp.fc1, b.mlp.fc2))
        named = dict(model.named_modules())
        b12 += sum(is_a8(m) for n, m in named.items()
                   if n.split(".")[0] in ("input_linear", "encoders", "enc_reduce_group"))
        encode = {
            "quant_matmul": b12,
            "swin_mlp_half_a8": sum(b.mlp_a8 for b in blocks),
            "swin_attn_half": sum(b.run_mode == "halves" for b in blocks),
            "swin_mlp_half": sum(b.run_mode == "halves" and not b.mlp_a8 for b in blocks),
            "swin_block": sum(b.run_mode == "full" for b in blocks),
            "window_transition": sum(l.blocks[-1].shift != 0 for l in multi),
            "window_attention": len(single), "patch_embed": 0, "downsample": 0,
        }
        dec = [m for n, m in named.items()
               if n.split(".")[0] in ("decoders", "dec_reduce_group", "vocab_linear")]
        cross = [m for layer in model.decoders for m in (layer.mha.Wk, layer.mha.Wv)]
        per_step = sum(is_a8(m) for m in dec) - sum(is_a8(m) for m in cross)
        decode = {"quant_matmul": sum(is_a8(m) for m in cross) + steps * per_step,
                  "dyn_exp_step": N_DEC * steps, "dyn_exp_cross_step": 0}
        return encode, decode

    def quant_path(self):
        """Phase 4, quantized serving: each run of QUANT_RUNS once through
        `Captioner.beam_search`, its launches held to the model's counts."""
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner

        imgs = self.images(B_SERVE, SEED)
        args = {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE}
        dense = self.serve["fused"].forward_enc(imgs).float()
        for run, (mode, step_impl) in QUANT_RUNS.items():
            cfg, model, (before, after) = self.quant_model(torch.bfloat16, self.dev, mode)
            serve = Captioner(model, cfg, args, step_impl=step_impl)
            self.serve[run] = serve
            self.counters(reset=True)
            caps, _ = serve.beam_search(imgs)
            torch.cuda.synchronize()
            self.launches[run] = self.counters()
            encode, decode = self.quant_launches(model, L_SERVE - 1)
            log(f"phase 4 quantized serving, run {run!r}: quantize_model(model, {mode!r}) over "
                f"every linear, {before / 1e6:.1f} MB -> {after / 1e6:.1f} MB of parameters; "
                f"attention_impl='fused', stage modes {model.swin_transf.stage_modes}, "
                f"step_impl={step_impl!r}, b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} bf16; lengths "
                f"{[len(c[0]) for c in caps]}; launches {self.launches[run]}")
            self.check_captions(caps, cfg.captioner, 1, L_SERVE)
            for name, k in KERNELS.items():
                n = self.launches[run][name]
                if (n > 0) != (run in k["paths"]):
                    raise AssertionError(
                        f"kernel {name}: {n} launches in run {run!r}, which "
                        f"{'runs' if run in k['paths'] else 'does not run'} it")
            want = {k: encode.get(k, 0) + decode.get(k, 0) for k in set(encode) | set(decode)}
            got = {k: self.launches[run][k] for k in want}
            if got != want:
                raise AssertionError(f"launches {got} != {want} in run {run!r}")
            self.counters(reset=True)
            enc = serve.forward_enc(imgs)
            torch.cuda.synchronize()
            got = {k: v for k, v in self.counters().items() if k in encode}
            log(f"  kernels in one encode, run {run!r}: {got}")
            if got != encode:
                raise AssertionError(f"encode launches {got} != {encode} in run {run!r}")
            diff = float((enc.float() - dense).square().mean().sqrt())
            log(f"  bf16 encoder output {tuple(enc.shape)} {enc.dtype}, run {run!r} against the "
                f"unquantized 'fused' run: rms of the difference {diff:.3e} on an rms of "
                f"{float(dense.square().mean().sqrt()):.3e}")
            if not bool(torch.isfinite(enc).all()):
                raise AssertionError(f"run {run!r}: encoder output not finite")

    def images(self, n, seed):
        return np.random.default_rng(seed).integers(0, 256, (n, 384, 384, 3), dtype=np.uint8)

    def gumbel(self, seed, shapes):
        """Standard Gumbel noise of the given shapes, made on the CPU from a
        seed, so that the card and the CPU can be handed the same numbers."""
        torch = self.torch
        g = torch.Generator().manual_seed(seed)
        tiny = torch.finfo(torch.float32).tiny
        return [-torch.log(-torch.log(torch.rand(s, generator=g).clamp_min(tiny)))
                for s in shapes]

    def check_captions(self, caps, cap, n_out, max_len):
        for row in caps:
            if len(row) != n_out:
                raise AssertionError(f"{len(row)} captions for an image, want {n_out}")
            for toks in row:
                if toks[0] != cap.sos_idx:
                    raise AssertionError(f"caption does not start with SOS: {toks}")
                if not 2 <= len(toks) <= max_len:
                    raise AssertionError(f"caption length {len(toks)} outside [2, {max_len}]")
                if max(toks) >= cap.vocab_size or min(toks) < 0:
                    raise AssertionError(f"token id out of range: {toks}")

    # -- phase 4 ---------------------------------------------------------------
    def main_path(self):
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner, EnsembleCaptioner
        from on_device_image_captioning_torch.ops import _cases

        imgs = self.images(B_SERVE, SEED)
        args = {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE}
        enc = {}
        for run, (path, halves, step_impl) in RUNS.items():
            cfg, model, _ = self.model(torch.bfloat16, self.dev, run)
            serve = Captioner(model, cfg, args, step_impl=step_impl)
            self.serve[run] = serve
            self.counters(reset=True)
            caps, _ = serve.beam_search(imgs)
            torch.cuda.synchronize()
            self.launches[run] = self.counters()
            cap = cfg.captioner
            lengths = [len(c[0]) for c in caps]
            log(f"phase 4 main path, run {run!r}: attention_impl={path!r}, stage modes "
                f"{model.swin_transf.stage_modes if path == 'fused' else '-'}, "
                f"step_impl={step_impl!r}: Swin-L/384 + d512 captioner, "
                f"V={cap.vocab_size}, b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} bf16; "
                f"lengths {lengths}; launches {self.launches[run]}")
            self.check_captions(caps, cap, 1, L_SERVE)
            for name, k in KERNELS.items():
                n = self.launches[run][name]
                if (n > 0) != (run in k["paths"]):
                    raise AssertionError(
                        f"kernel {name}: {n} launches in run {run!r}, which "
                        f"{'runs' if run in k['paths'] else 'does not run'} it")
            got = {k: self.launches[run][k] for k in DECODE_LAUNCHES[step_impl]}
            if got != DECODE_LAUNCHES[step_impl]:
                raise AssertionError(
                    f"decode-step launches {got} != {DECODE_LAUNCHES[step_impl]} in run {run!r}")
            enc[run] = serve.forward_enc(imgs)
        for run, want in ENCODE_LAUNCHES.items():
            self.counters(reset=True)
            self.serve[run].forward_enc(imgs)
            torch.cuda.synchronize()
            got = {k: v for k, v in self.counters().items() if k in want}
            log(f"  window-resident kernels in one encode, run {run!r}: {got}")
            if got != want:
                raise AssertionError(f"window-resident launches {got} != {want} in run {run!r}")
        # The paths round at other places (q scaled in fp32 or in bf16,
        # probabilities normalized before or after their rounding), and the
        # one-ulp differences compound through 24 blocks and 3 encoder layers
        # into noise on a layer-normalized output (rms 1). So the bf16
        # tolerance of the kernel cases (2e-2) is held at the level of the
        # root mean square, and no single element of the ~6e5 may be off by
        # more than five times that. The two forms of the "fused" path round
        # at the same places and are held to each other in the same way.
        rtol = _cases.TOL[torch.bfloat16][1]
        for one, other in (("fused", "pallas"), ("fused", "fused_halves")):
            a, b = enc[one].float(), enc[other].float()
            diff, rms = float((a - b).square().mean().sqrt()), float(b.square().mean().sqrt())
            max_abs = float((a - b).abs().max())
            log(f"  bf16 encoder output {tuple(a.shape)}, run {one!r} vs {other!r}: rms of the "
                f"difference {diff:.3e} on an rms of {rms:.3e} (tol {rtol:g} x rms), "
                f"max_abs={max_abs:.3e} (tol {5 * rtol:g} x rms)")
            if not (diff <= rtol * rms and max_abs <= 5 * rtol * rms):
                raise AssertionError(f"runs {one!r} and {other!r} disagree at bf16")

        # sampling and a two-model ensemble on the default-modes path
        base = self.serve["fused"]
        cap = base.cap_cfg
        sampler = Captioner(base.model, base.cfg, {"how_many_outputs": N_SAMPLES,
                            "sample_max_seq_len": L_SERVE}, step_impl="pallas_fused")
        self.counters(reset=True)
        caps, lps = sampler.sample(imgs, generator=torch.Generator(device=self.dev).manual_seed(SEED))
        torch.cuda.synchronize()
        n = self.counters()
        log(f"phase 4 sampling, b{B_SERVE} x {N_SAMPLES} samples / L{L_SERVE} bf16, "
            f"step_impl='pallas_fused': log-probs {tuple(lps.shape)}, lengths "
            f"{[len(c) for c in caps[0]]}; B16 launches {n['dyn_exp_cross_step']}, K2 {n['dyn_exp_step']}")
        self.check_captions(caps, cap, N_SAMPLES, L_SERVE + 1)
        if tuple(lps.shape) != (B_SERVE, N_SAMPLES, L_SERVE + 1) or not bool(
                torch.isfinite(lps).all()):
            raise AssertionError(f"sampled log-probs {tuple(lps.shape)} not finite or misshapen")
        if n["dyn_exp_cross_step"] != N_DEC * L_SERVE or n["dyn_exp_step"] != 0:
            raise AssertionError("the sampling run did not go through B16 alone")
        cfg2, model2, _ = self.model(torch.bfloat16, self.dev, "fused", seed=SEED + 1)
        second = Captioner(model2, cfg2, args, step_impl="pallas_fused")
        self.counters(reset=True)
        caps = EnsembleCaptioner([base, second])(imgs)[0]
        torch.cuda.synchronize()
        n = self.counters()
        log(f"phase 4 ensemble of two models, b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE}, fp32 "
            f"caches: lengths {[len(c[0]) for c in caps]}; B16 launches "
            f"{n['dyn_exp_cross_step']}, B6 {n['swin_block']}")
        self.check_captions(caps, cap, 1, L_SERVE)
        if n["dyn_exp_cross_step"] != 2 * N_DEC * (L_SERVE - 1) or n["swin_block"] != 8:
            raise AssertionError("the ensemble run did not drive both models' kernels")
        del second, model2
        torch.cuda.empty_cache()

    # -- phase 5 ---------------------------------------------------------------
    def compare_tokens(self, what, got, want, margin_of, near_tie=1e-4):
        """Token lists of the card against the CPU's. Where they part, the
        CPU's margin between the two tokens at that step must be a near-tie
        (fp32 sums in another order can flip one); anything else fails."""
        agree = total = 0
        for i, (rows_a, rows_b) in enumerate(zip(got, want)):
            for j, (a, b) in enumerate(zip(rows_a, rows_b)):
                total += max(len(a), len(b))
                agree += sum(x == y for x, y in zip(a, b))
                if a == b:
                    continue
                t = next((s for s in range(min(len(a), len(b))) if a[s] != b[s]),
                         min(len(a), len(b)))
                margin = margin_of(i, j, t, a, b) if t < min(len(a), len(b)) else float("inf")
                log(f"  {what}: image {i} caption {j} diverges at step {t}, margin {margin:.3e}")
                if not margin < near_tie:
                    raise AssertionError(f"{what}: captions diverge at more than a near-tie")
        log(f"  {what}: token agreement {agree}/{total}")

    def self_check(self):
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner, EnsembleCaptioner
        from on_device_image_captioning_torch.decode import cache as dc

        args = {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE}
        cfg, cpu_model, _ = self.model(torch.float32, "cpu")
        cpu = Captioner(cpu_model, cfg, args, device="cpu")
        imgs = self.images(2, SEED + 1)
        cap = cfg.captioner

        def first_step(c_, enc):
            st = dc.init_state(c_.model, cap, enc, L_SERVE)
            sos = torch.full((2,), cap.sos_idx, dtype=torch.int32, device=enc.device)
            return dc.dec_step(c_.model, cap, st, sos, 0, torch.float32,
                               step_impl=c_.step_impl)[0]

        with torch.inference_mode():
            enc_c = cpu.forward_enc(imgs)
            lp_c = first_step(cpu, enc_c)
        caps_c, _ = cpu.beam_search(imgs)

        def beam_margin(i, j, t, a, b):
            with torch.inference_mode():
                prefix = torch.tensor([b[:t]], dtype=torch.int64)
                lp = cpu_model.forward_dec(enc_c[i:i + 1], prefix, apply_log_softmax=True)
            return abs(float(lp[0, t - 1, a[t]] - lp[0, t - 1, b[t]]))

        # fp32 through 24 Swin blocks + 3 encoder layers on both sides, only the
        # summation order differs: the tests' tolerance through the stacks
        atol = 1e-4
        gpu_caps, fused = {}, None
        for run in RUNS:
            gpu_cfg, gpu_model, step_impl = self.model(torch.float32, self.dev, run)
            gpu = Captioner(gpu_model, gpu_cfg, args, step_impl=step_impl)
            with torch.inference_mode():
                enc_g = gpu.forward_enc(imgs)
                lp_g = first_step(gpu, enc_g)
            enc_err = float((enc_g.cpu() - enc_c).abs().max())
            lp_err = float((lp_g.cpu() - lp_c).abs().max())
            log(f"phase 5 fp32 card kernels (run {run!r}, step_impl={step_impl!r}) vs CPU plain "
                f"path: encoder max_abs={enc_err:.3e}, first-step log-probs "
                f"max_abs={lp_err:.3e} (tol atol {atol:g})")
            if not (enc_err <= atol and lp_err <= atol):
                raise AssertionError(f"run {run!r} and the plain path disagree at fp32")
            enc_16 = self.serve[run].forward_enc(imgs).float()
            log(f"  bf16 run {run!r} against this fp32 result: rms of the difference "
                f"{float((enc_16 - enc_g).square().mean().sqrt()):.3e}")
            gpu_caps[run], _ = gpu.beam_search(imgs)
            self.compare_tokens(f"card ({run!r}) vs CPU", gpu_caps[run], caps_c, beam_margin)
            if run == "fused":
                fused = (gpu_cfg, gpu_model, gpu)
            else:
                del gpu, gpu_model
                torch.cuda.empty_cache()
        self.compare_tokens("card step_impl 'pallas_fused' vs card 'pallas' (fused backbone)",
                            gpu_caps["fused"], gpu_caps["fused_halves"], beam_margin)

        # sampling: the same Gumbel noise to the card (B16 step) and to the CPU
        gpu_cfg, gpu_model, gpu = fused
        sargs = {"how_many_outputs": N_SAMPLES, "sample_max_seq_len": L_SERVE}
        noise = self.gumbel(SEED + 5, [(2 * N_SAMPLES, cap.vocab_size)] * L_SERVE)
        s_cpu, lp_s_cpu = Captioner(cpu_model, cfg, sargs, device="cpu").sample(imgs, noise=noise)
        s_gpu, lp_s_gpu = Captioner(gpu_model, gpu_cfg, sargs, step_impl="pallas_fused").sample(
            imgs, noise=noise)

        def sample_margin(i, j, t, a, b):
            with torch.inference_mode():
                prefix = torch.tensor([b[:t]], dtype=torch.int64)
                lp = cpu_model.forward_dec(enc_c[i:i + 1], prefix, apply_log_softmax=True)
            g = noise[t - 1][i * N_SAMPLES + j]
            return abs(float(lp[0, t - 1, a[t]] + g[a[t]] - lp[0, t - 1, b[t]] - g[b[t]]))

        log(f"phase 5 sampling 2 x {N_SAMPLES} / L{L_SERVE} fp32, same noise: log-probs "
            f"{tuple(lp_s_gpu.shape)}, max_abs "
            f"{float((lp_s_gpu.cpu() - lp_s_cpu).abs().max()):.3e} against the CPU's")
        if tuple(lp_s_gpu.shape) != (2, N_SAMPLES, L_SERVE + 1):
            raise AssertionError("sampled log-probs misshapen")
        self.compare_tokens("sampling, card vs CPU", s_gpu, s_cpu, sample_margin)

        # ensemble of two models: card (B6 + B16) against the CPU plain path
        cfg2, cpu_model2, _ = self.model(torch.float32, "cpu", seed=SEED + 1)
        gcfg2, gpu_model2, _ = self.model(torch.float32, self.dev, "fused", seed=SEED + 1)
        cpu2 = Captioner(cpu_model2, cfg2, args, device="cpu")
        e_cpu = EnsembleCaptioner([cpu, cpu2])(imgs)[0]
        e_gpu = EnsembleCaptioner(
            [gpu, Captioner(gpu_model2, gcfg2, args, step_impl="pallas_fused")])(imgs)[0]
        with torch.inference_mode():
            enc_c2 = cpu2.forward_enc(imgs)

        def ensemble_margin(i, j, t, a, b):
            with torch.inference_mode():
                prefix = torch.tensor([b[:t]], dtype=torch.int64)
                lps = [m.forward_dec(e[i:i + 1], prefix, apply_log_softmax=True)[0, t - 1]
                       for m, e in ((cpu_model, enc_c), (cpu_model2, enc_c2))]
            lp = torch.log(torch.exp(torch.stack(lps)).mean(dim=0))
            return abs(float(lp[a[t]] - lp[b[t]]))

        log(f"phase 5 ensemble of two models, 2 images / beam {BEAM_SERVE} / L{L_SERVE} fp32")
        self.compare_tokens("ensemble, card vs CPU", e_gpu, e_cpu, ensemble_margin)
        del gpu, gpu_model, gpu_model2, fused
        torch.cuda.empty_cache()

    def quant_modules(self, cpu_model, gpu_model, x, dtype):
        """Every module of the quantized encoder on the card, fed the CPU plain
        path's input to it (so each comparison starts from the same values):
        the patch embed, each block of the multi-window stages (window
        layout), the transitions back, each patch merging, the single-window
        blocks, the caption encoder's input linear, layers and reduction.
        Each output within 1e-2 of its max and 1e-3 of its RMS: an int8 (or,
        under w8, bf16) rounding of an activation can go one step the other
        way and move its row. Returns [(module, share of max, share of RMS)]."""
        torch = self.torch
        from on_device_image_captioning_torch.models.common import layernorm, linear
        from on_device_image_captioning_torch.ops.swin_block_fused import window_transition
        from on_device_image_captioning_torch.ops.window_layout import window_partition, window_reverse

        dev, shares = self.dev, []

        def hold(what, got, want):
            diff = got.float().cpu() - want.float()
            shares.append((what, float(diff.abs().max()) / float(want.abs().max()),
                           float(diff.square().mean().sqrt()) / float(want.float().square().mean().sqrt())))

        sc, sg = cpu_model.swin_transf, gpu_model.swin_transf
        xc = sc.patch_embed(x, dtype)
        hold("patch embed", sg.patch_embed(x.to(dev), dtype), xc)
        for i, (lc, lg) in enumerate(zip(sc.layers, sg.layers)):
            b, l, c = xc.shape
            res, window = lc.blocks[0].res, lc.blocks[0].window
            if res > window:
                xw, shift = window_partition(xc.reshape(b, res, res, c), window).contiguous(), 0
                for j, (bc, bg) in enumerate(zip(lc.blocks, lg.blocks)):
                    want = bc.forward_windows(xw, shift)
                    hold(f"stage {i} block {j}", bg.forward_windows(xw.to(dev), shift), want)
                    xw, shift = want, bc.shift
                if shift:
                    want = window_transition(xw, res, window, shift, 0)
                    hold(f"stage {i} exit transition",
                         window_transition(xw.to(dev), res, window, shift, 0), want)
                    xw = want
                xc = window_reverse(xw, window, res, res).reshape(b, l, c)
            else:
                for j, (bc, bg) in enumerate(zip(lc.blocks, lg.blocks)):
                    want = bc(xc, dtype)
                    hold(f"stage {i} block {j}", bg(xc.to(dev), dtype), want)
                    xc = want
            if lc.downsample is not None:
                want = lc.downsample(xc, dtype)
                hold(f"patch merging {i}", lg.downsample(xc.to(dev), dtype), want)
                xc = want
        feats = layernorm(sc.norm, xc)
        # the caption encoder (`ExpansionNetV2.forward_enc` without pads), layer by layer
        xc = linear(cpu_model.input_linear, feats, dtype)
        hold("input linear", linear(gpu_model.input_linear, feats.to(dev), dtype), xc)
        outs = []
        for k, (ec, eg) in enumerate(zip(cpu_model.encoders, gpu_model.encoders)):
            want = ec(xc, None, dtype)
            hold(f"caption encoder layer {k}", eg(xc.to(dev), None, dtype), want)
            xc = want
            outs.append(want)
        cat = torch.cat(outs, dim=-1)
        want = layernorm(cpu_model.enc_reduce_norm,
                         xc + linear(cpu_model.enc_reduce_group, cat, dtype))
        hold("caption encoder reduction", layernorm(
            gpu_model.enc_reduce_norm,
            xc.to(dev) + linear(gpu_model.enc_reduce_group, cat.to(dev), dtype)), want)
        return shares

    def quant_check(self):
        """Phase 5, quantized: the w8a8 and w8 models at fp32, 2 images, on the
        card against the CPU's plain path with the same int8 weights."""
        import copy

        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.decode import beam_search as bs
        from on_device_image_captioning_torch.deploy.quantization import quantize_model
        from on_device_image_captioning_torch.utils.image import normalize_on_device

        args = {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE}
        imgs = self.images(2, SEED + 1)
        x = normalize_on_device(torch.from_numpy(imgs))
        for run, (mode, step_impl) in QUANT_RUNS.items():
            cfg, cpu_model, _ = self.model(torch.float32, "cpu", "fused")
            quantize_model(cpu_model, mode)
            gpu_model = copy.deepcopy(cpu_model).to(self.dev)
            cpu = Captioner(cpu_model, cfg, args, device="cpu")
            gpu = Captioner(gpu_model, cfg, args, step_impl=step_impl)
            with torch.inference_mode():
                shares = self.quant_modules(cpu_model, gpu_model, x, cfg.compute_dtype)
                enc_c = cpu.forward_enc(imgs)
                enc_g = gpu.forward_enc(imgs).cpu()
            # the CPU against itself with the patch embed's LayerNorm scale nudged
            # by 1e-7 relative: how far a last-place difference carries
            scale = cpu_model.swin_transf.patch_embed.norm.weight
            kept = scale.detach().clone()
            with torch.no_grad():
                scale.mul_(1 + 1e-7 * torch.randn(scale.shape, generator=torch.Generator().manual_seed(SEED)))
            with torch.inference_mode():
                enc_n = cpu.forward_enc(imgs)
            with torch.no_grad():
                scale.copy_(kept)
            log(f"phase 5 fp32 card kernels (run {run!r}, step_impl={step_impl!r}) vs CPU plain "
                f"path, same int8 weights, each module on the CPU's input to it (tol 1e-2 of its "
                f"max, 1e-3 of its RMS): worst {max(m for _, m, _ in shares):.3e} of max, "
                f"{max(r for _, _, r in shares):.3e} of RMS; per module (max, RMS): "
                + "; ".join(f"{w} {m:.1e} {r:.1e}" for w, m, r in shares))
            bad = [w for w, m, r in shares if not (m <= 1e-2 and r <= 1e-3)]
            if bad:
                raise AssertionError(f"run {run!r}: card against CPU outside tolerance at {bad}")

            def rms(a):
                return float(a.square().mean().sqrt())

            card, self_ = rms(enc_g - enc_c), rms(enc_n - enc_c)
            log(f"  free-running encoder output: card vs CPU rms of the difference {card:.3e}, "
                f"max_abs {float((enc_g - enc_c).abs().max()):.3e} on a max of "
                f"{float(enc_c.abs().max()):.3e}; the CPU against itself with the patch embed's "
                f"LayerNorm scale nudged by 1e-7 relative: rms {self_:.3e}, max_abs "
                f"{float((enc_n - enc_c).abs().max()):.3e} "
                f"(tol: card <= 5 x that + 1e-5)")
            if not card <= 5 * self_ + 1e-5:
                raise AssertionError(f"run {run!r}: the card's encoder output departs from the "
                                     "CPU's more than a last-place nudge does")

            def margin(i, j, t, a, b, model=cpu_model, enc=enc_c):
                with torch.inference_mode():
                    prefix = torch.tensor([b[:t]], dtype=torch.int64)
                    lp = model.forward_dec(enc[i:i + 1], prefix, apply_log_softmax=True)
                return abs(float(lp[0, t - 1, a[t]] - lp[0, t - 1, b[t]]))

            # decoding the CPU's encoder output on both sides; an int8 value one
            # step off moves a log-prob by up to ~1e-2
            with torch.inference_mode():
                caps_g = bs.captions_from_result(gpu.decode(enc_c.to(self.dev)))[0]
                caps_c = bs.captions_from_result(cpu.decode(enc_c))[0]
            self.compare_tokens(f"decode of the CPU's encoder output, card ({run!r}) vs CPU",
                                caps_g, caps_c, margin, near_tie=2e-2)
            free_g, free_c = gpu.beam_search(imgs)[0], cpu.beam_search(imgs)[0]
            same = sum(a == b for rg, rc in zip(free_g, free_c) for a, b in zip(rg, rc))
            log(f"  free-running captions, card vs CPU: {same} of {len(free_c)} equal")
            del gpu, gpu_model, cpu, cpu_model
            torch.cuda.empty_cache()

    # -- training --------------------------------------------------------------
    def train_model(self, dtype, device, depths=None, dropout=0.1):
        """(cfg, model) of the training run: the "fused" path with stochastic
        depth 0.1 and the caption head's dropouts, seeded random weights."""
        import dataclasses

        torch = self.torch
        from on_device_image_captioning_torch.config import DropConfig, end_expansionnet_v2_coco
        from on_device_image_captioning_torch.models.end_to_end import (
            EndExpansionNetV2, init_weights,
        )

        drop = DropConfig(*([dropout] * 5))
        cfg = end_expansionnet_v2_coco(drop, compute_dtype=dtype)
        swin = dataclasses.replace(cfg.swin, attention_impl="fused", drop_path_rate=0.1)
        if depths is not None:
            swin = dataclasses.replace(swin, depths=depths)
        cfg = dataclasses.replace(cfg, swin=swin)
        model = init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(SEED))
        return cfg, model.to(device)

    def train_batch(self, n, cfg, device):
        torch = self.torch
        rng = np.random.default_rng(SEED + 7)
        cap = cfg.captioner
        captions = rng.integers(4, cap.vocab_size, (n, L_TRAIN))
        captions[:, 0] = cap.sos_idx
        return {"enc_input": torch.from_numpy(self.images(n, SEED + 7)).to(device),
                "captions": torch.from_numpy(captions).to(device)}

    def train_path(self):
        """Phase 4, training: XE steps at full width and depth on the card."""
        torch = self.torch
        from on_device_image_captioning_torch.train.radam import PlainRAdam
        from on_device_image_captioning_torch.train.train_step import make_xe_step

        cfg, model = self.train_model(torch.bfloat16, self.dev)
        batch = self.train_batch(B_TRAIN, cfg, self.dev)
        optimizer = PlainRAdam(model.parameters(), TRAIN_LR)
        step = make_xe_step(model, cfg, optimizer)
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        losses = []
        for i in range(TRAIN_STEPS):
            self.counters(reset=True)
            losses.append(float(step(batch, gen)["loss"]))
            torch.cuda.synchronize()
            counts = self.counters()
            got = {k: counts[k] for k in TRAIN_LAUNCHES}
            if got != TRAIN_LAUNCHES:
                raise AssertionError(f"training launches {got} != {TRAIN_LAUNCHES} in step {i}")
            for name, k in KERNELS.items():
                if (counts[name] > 0) != (TRAIN in k["paths"]):
                    raise AssertionError(
                        f"kernel {name}: {counts[name]} launches in an XE step, which "
                        f"{'runs' if TRAIN in k['paths'] else 'does not run'} it")
        self.launches[TRAIN] = counts
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        log(f"phase 4 training, run {TRAIN!r}: Swin-L/384 depths {cfg.swin.depths} + d512 "
            f"captioner, attention_impl='fused', stage modes {model.swin_transf.stage_modes}, "
            f"bf16 over fp32 masters, b{B_TRAIN}, drop-path 0.1, dropouts 0.1, captions of "
            f"{L_TRAIN} ids, PlainRAdam lr {TRAIN_LR}: loss per step "
            f"{[round(x, 4) for x in losses]}; launches per step {counts}; "
            f"{sum(1 for _ in model.parameters())} parameters, {len(bad)} without a finite gradient")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"XE loss not finite or not falling: {losses}")
        if bad:
            raise AssertionError(f"parameters without a finite gradient: {bad[:5]}")
        self.trainer = (cfg, model, optimizer, step, batch, gen)

    def relu_signs(self, fn, impose=None):
        """fn() with `torch.relu` replaced for the call (only the caption head
        calls it): returns fn's result and the pattern `x > 0` of every call,
        in order, on the CPU. With `impose`, such a list, each call passes its
        input where the pattern says so and 0 elsewhere, whatever the input's
        own sign, and its gradient follows the pattern too."""
        torch = self.torch
        real, seen, given = torch.relu, [], iter(impose or ())

        def relu(x):
            seen.append((x > 0).cpu())
            if impose is None:
                return real(x)
            return torch.where(next(given).to(x.device), x, torch.zeros_like(x))

        torch.relu = relu
        try:
            return fn(), seen
        finally:
            torch.relu = real

    def train_check(self):
        """Phase 5, training: fp32 loss and gradients of the kernel path on the
        card against the plain path on the CPU, depths (2, 2, 2, 2)."""
        torch = self.torch
        from on_device_image_captioning_torch.models.common import drop_path_scale
        from on_device_image_captioning_torch.train.train_step import xe_loss

        depths = (2, 2, 2, 2)
        cfg, cpu_model = self.train_model(torch.float32, "cpu", depths, dropout=0.0)
        gen = torch.Generator().manual_seed(SEED + 9)
        scales = [(drop_path_scale(0.3, 2, gen, "cpu"), drop_path_scale(0.3, 2, gen, "cpu"))
                  for _ in range(sum(depths))]
        batch = self.train_batch(2, cfg, "cpu")
        loss_c, signs_c = self.relu_signs(
            lambda: xe_loss(cpu_model, cfg, batch, drop_path_scales=scales))
        loss_c.backward()
        want = {n: p.grad for n, p in cpu_model.named_parameters()}
        top = max(float(g.abs().max()) for g in want.values())
        loss_c = float(loss_c.detach())
        _, gpu_model = self.train_model(torch.float32, self.dev, depths, dropout=0.0)
        gpu_batch = {k: v.to(self.dev) for k, v in batch.items()}
        gpu_scales = [tuple(m.to(self.dev) for m in pair) for pair in scales]

        def card(tols, impose=None):
            """One forward and backward on the card: (loss, ReLU patterns,
            per group the worst gradient as a share of its tolerance)."""
            gpu_model.zero_grad(set_to_none=True)
            loss, signs = self.relu_signs(
                lambda: xe_loss(gpu_model, cfg, gpu_batch, drop_path_scales=gpu_scales), impose)
            loss.backward()
            torch.cuda.synchronize()
            worst = {group: (0.0, "") for group in tols}
            for name, p in gpu_model.named_parameters():
                group = "swin_transf." if name.startswith("swin_transf.") else "caption head"
                w, tol = want[name], tols[group]
                err = float((p.grad.cpu() - w).abs().max())
                share = err / (tol * float(w.abs().max()) + 0.1 * tol * top)
                if not share <= worst[group][0]:  # also catches NaN
                    worst[group] = (share, name)
            return float(loss.detach()), signs, worst

        def held(loss, worst):
            return abs(loss - loss_c) <= 2e-4 * abs(loss_c) and all(
                v <= 1.0 for v, _ in worst.values())

        def show(tols, worst):
            return "; ".join(f"{g} (tol {tols[g]:g}) {v:.3f} at {n}" for g, (v, n) in worst.items())

        # fp32 on both sides through 8 blocks and 6 caption layers, forward and
        # backward: the sums run in another order (atomic adds on the card). Each
        # gradient is held relative to its own largest magnitude, plus a tenth
        # of that relative to the largest gradient of the model for the tensors
        # that are zero in exact arithmetic (the k bias under the softmax, a
        # LayerNorm bias under the next norm). Free-running, the caption head
        # (the same plain tensor code on both sides) gets 1e-3: another
        # summation order flips a ReLU (FF, the expansions' ReLU(+-z)) wherever
        # its input is within rounding of 0, and that moves one term of a
        # weight gradient outright (and, through the head's backward, the
        # backbone's gradients by less). The second pass shows it: the flips
        # are counted (3 of 5.6 million on an H100), and with the CPU's ReLU
        # patterns imposed on the card's head every gradient, the head's too,
        # is held to 5e-5.
        free_tols = {"swin_transf.": 2e-4, "caption head": 1e-3}
        same_tols = {"swin_transf.": 5e-5, "caption head": 5e-5}
        self.counters(reset=True)
        loss_g, signs_g, free = card(free_tols)
        counts = self.counters()
        flips = sum(int((a != b).sum()) for a, b in zip(signs_g, signs_c))
        loss_s, _, same = card(same_tols, impose=signs_c)
        log(f"phase 5 training fp32, depths {depths}, b2, card kernels vs CPU plain path: loss "
            f"{loss_g:.6f} vs {loss_c:.6f} (tol 2e-4 relative); gradients of {len(want)} "
            f"parameters, each within tol x its tensor's max + 0.1 tol x the largest gradient "
            f"({top:.3e}); worst share of that: {show(free_tols, free)}; launches "
            f"{({k: counts[k] for k in TRAIN_LAUNCHES})}")
        log(f"  {flips} of {sum(a.numel() for a in signs_c)} ReLU inputs in {len(signs_c)} calls "
            f"have another sign on the card than on the CPU; with the CPU's signs imposed on the "
            f"card: loss {loss_s:.6f}, worst share: {show(same_tols, same)}")
        if len(signs_g) != len(signs_c) or not (held(loss_g, free) and held(loss_s, same)):
            raise AssertionError("the training kernel path and the plain path disagree at fp32")
        if counts["swin_block_train"] != 4 or counts["swin_attn_bwd"] != 6:
            raise AssertionError("the fp32 training check did not go through the kernels")

    def train_timing(self):
        """Phase 6, training: ms per XE step and its split (CUDA events around
        forward, backward and optimizer of the same steps), peak memory."""
        torch = self.torch
        from on_device_image_captioning_torch.train.train_step import xe_loss

        cfg, model, optimizer, step, batch, gen = self.trainer
        torch.cuda.reset_peak_memory_stats()
        marks = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            optimizer.zero_grad(set_to_none=True)
            ev[0].record()
            loss = xe_loss(model, cfg, batch, gen)
            ev[1].record()
            loss.backward()
            ev[2].record()
            optimizer.step()
            ev[3].record()
            torch.cuda.synchronize()
            marks.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        fwd, bwd, opt = (statistics.median(m[i] for m in marks) for i in range(3))
        peak = torch.cuda.max_memory_allocated() / 2**20
        whole = self.cuda_time(lambda: step(batch, gen), iters=3, warmup=0)
        log(f"  XE step b{B_TRAIN} bf16, Swin-L/384 + d512, drop-path 0.1, dropouts 0.1: "
            f"{whole:.2f} ms per step (CUDA events, 3 steps); forward {fwd:.2f} ms, backward "
            f"{bwd:.2f} ms, optimizer {opt:.2f} ms (medians of 3 steps {marks}); peak device "
            f"memory {peak:.0f} MiB of this step | {self.card}")

    # -- phase 6 ---------------------------------------------------------------
    def kernel_timing(self, names=None):
        from on_device_image_captioning_torch.ops import _cases

        log(f"phase 6 times, CUDA events, ms per call ({self.card})")
        for name in names or _cases.CASES:
            for case in _cases.CASES[name](self.dev):
                ms = self.cuda_time(case.time_kernel or case.run_kernel)
                plain_ms = self.cuda_time(case.time_plain or case.run_plain)
                library = self.library_call(case)
                library_ms = None if library is None else self.cuda_time(library)
                peak = (INT8_OPS if case.int8 else
                        BF16_FLOPS if case.matmul and "bfloat16" in case.label else FP32_FLOPS)
                by_bytes, by_ops = 1e3 * case.nbytes / HBM_BYTES_S, 1e3 * case.flops / peak
                bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
                if case.label == KERNELS[case.kernel]["headline"]:
                    self.times[case.kernel] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)
                lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
                log(f"  {case.kernel} {case.label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.5f} ms by {bound_by} ({case.nbytes} B, {case.flops} flop), "
                    f"library {lib} | {self.card}")

    def path_timing(self):
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner

        imgs8 = self.images(B_SERVE, SEED + 2)
        order = ("pallas", "fused", "fused_halves", "fused_halves", "fused", "pallas")
        enc_ms = {r: [] for r in RUNS}
        for run in order:
            enc_ms[run].append(self.cuda_time(
                lambda: self.serve[run].forward_enc(imgs8), iters=5, warmup=1))
        for run in RUNS:
            log(f"  encode b{B_SERVE} bf16, run {run!r}: "
                f"{statistics.mean(enc_ms[run]):.3f} ms (CUDA events, 2 x 5 calls in the order "
                f"{', '.join(order)}: {[round(t, 3) for t in enc_ms[run]]}) | {self.card}")

        def wall(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        # decode alone, both step paths on one model and one encoder output,
        # in turns within this call (host clock: decode is host-bound)
        base = self.serve["fused"]
        cross = base.forward_enc(imgs8)
        steppers = {impl: Captioner(base.model, base.cfg, base.beam_search_args, step_impl=impl)
                    for impl in ("pallas", "pallas_fused")}
        step_order = ("pallas", "pallas_fused", "pallas_fused", "pallas")
        dec_s = {impl: [] for impl in steppers}
        for impl in steppers:
            wall(lambda: steppers[impl].decode(cross))
        for impl in step_order * 2:
            dec_s[impl].append(wall(lambda: steppers[impl].decode(cross)))
        for impl in steppers:
            per_step = 1000 * statistics.median(dec_s[impl]) / (L_SERVE - 1)
            log(f"  decode b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} bf16, step_impl={impl!r}: "
                f"{per_step:.4f} ms per step (host clock, median of {len(dec_s[impl])} decodes "
                f"of {L_SERVE - 1} steps in the order {', '.join(step_order)} twice: "
                f"{[round(1000 * t, 3) for t in dec_s[impl]]} ms) | {self.card}")

        # quantized serving: encode against the unquantized "fused" form in
        # turns, decode per step and img/s of the w8a8 model
        q_order = ("fused", "w8a8", "w8", "w8", "w8a8", "fused")
        q_ms = {r: [] for r in ("fused", "w8a8", "w8")}
        for run in q_order:
            q_ms[run].append(self.cuda_time(
                lambda: self.serve[run].forward_enc(imgs8), iters=5, warmup=1))
        for run in ("w8a8", "w8"):
            log(f"  encode b{B_SERVE} bf16, run {run!r}: {statistics.mean(q_ms[run]):.3f} ms against "
                f"'fused' {statistics.mean(q_ms['fused']):.3f} ms (CUDA events, 2 x 5 calls in the "
                f"order {', '.join(q_order)}: {[round(t, 3) for t in q_ms[run]]}) | {self.card}")
        qserve = self.serve["w8a8"]
        qcross = qserve.forward_enc(imgs8)
        wall(lambda: qserve.decode(qcross))
        q_dec = [wall(lambda: qserve.decode(qcross)) for _ in range(3)]
        log(f"  decode b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} bf16, run 'w8a8': "
            f"{1000 * statistics.median(q_dec) / (L_SERVE - 1):.4f} ms per step (host clock, "
            f"median of 3 decodes {[round(1000 * t, 3) for t in q_dec]} ms) | {self.card}")
        q_serve = [wall(lambda: qserve.beam_search(imgs8)) for _ in range(3)]
        log(f"  end to end b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} bf16, run 'w8a8': "
            f"{B_SERVE / statistics.median(q_serve):.3f} img/s (median of 3 runs "
            f"{[round(t, 4) for t in q_serve]} s) | {self.card}")

        serve = self.serve["pallas"]
        run = lambda captioner, imgs: wall(lambda: captioner.beam_search(imgs))  # noqa: E731
        run(serve, imgs8)
        serve_s = [run(serve, imgs8) for _ in range(3)]
        ips = B_SERVE / statistics.median(serve_s)
        lat = Captioner(serve.model, serve.cfg,
                        {"beam_size": BEAM_LAT, "beam_max_seq_len": L_LAT})
        img1 = self.images(1, SEED + 3)
        run(lat, img1)
        lat_s = [run(lat, img1) for _ in range(5)]
        log(f"  end to end b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} bf16: {ips:.3f} img/s "
            f"(median of {len(serve_s)} runs {[round(s, 4) for s in serve_s]} s) | {self.card}")
        log(f"  p50 latency b1/beam {BEAM_LAT}/L{L_LAT} bf16: "
            f"{1000 * statistics.median(lat_s):.2f} ms "
            f"(runs {[round(1000 * s, 2) for s in lat_s]} ms) | {self.card}")


def main(names) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    unknown = [n for n in names if n not in KERNELS]
    if unknown:
        print(f"chip_smoke: no kernel named {unknown}; there are {list(KERNELS)}", file=sys.stderr)
        return 1
    smoke = Smoke(torch)
    smoke.device()
    smoke.build()
    if names:
        smoke.kernels(names)
        smoke.kernel_timing(names)
        log(f"checked and timed {names} only: no result")
        return 0
    smoke.kernels()
    smoke.main_path()
    smoke.quant_path()
    smoke.train_path()
    smoke.self_check()
    smoke.quant_check()
    smoke.train_check()
    smoke.kernel_timing()
    smoke.path_timing()
    smoke.train_timing()
    kernels = []
    for name, k in KERNELS.items():
        by_path = {r: smoke.launches[r][name] for r in smoke.launches}
        kernels.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": by_path[k["paths"][0]],
            "max_abs_err": smoke.errors[name], **smoke.times[name],
            "launches_by_path": by_path,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
