#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`on_device_image_captioning_torch`) on one
NVIDIA card: the quickest proof that the port builds, is right and runs.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero before the result):

1. Device: card name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compile every kernel of the main path from the sources in the
   checkout (CUDA through nvcc, all sources at once; Triton through its JIT)
   and print the seconds.
3. Each kernel against its plain PyTorch version on the card, at main-path
   shapes, in fp32 and bf16, with the tolerance printed beside each check.
4. Main path at full width, once per backbone path (`attention_impl`
   "pallas", then "fused"): Swin-L/384 + the d512 captioner, V = 10000,
   seeded random weights, `api.Captioner` beam search on 8 uint8 images at
   384^2, beam 3, max_seq_len 20, bf16. The launch counters are set to 0
   before each run and read after it; every kernel of that path must have
   been launched, the window-resident kernels exactly as often as the model
   has blocks and stages. The two paths' encoder outputs must agree within
   the bf16 tolerance.
5. The paths held to the plain path: 2 images at fp32 through each kernel
   path on the card and through the plain path on the CPU, same weights.
6. Times: each kernel against its plain version, its bound (the least time
   the card could take, from the case's bytes and operations) and, where one
   PyTorch call computes the same function, that call (CUDA events); encode
   ms of both paths; end-to-end img/s at b8/beam 3/L20 and p50 latency at
   b1/beam 5/L74, bf16, on the default path.

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
PATHS = ("pallas", "fused")
# published peaks of one H100 SXM (dense): device memory bytes/s; bf16 matrix
# products on the tensor cores; fp32 outside them
HBM_BYTES_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
_TPU = "on_device_image_captioning_tpu/ops/"
_PORT = "on_device_image_captioning_torch/"
# kernel -> route, source, the TPU kernel it replaces, (ops module, launch
# counter), the paths that run it, and the phase-6 case whose times go into
# the {"kernels": ...} line
KERNELS = {
    "window_attention": dict(
        route="cuda", source=_PORT + "csrc/window_attention.cu",
        replaces=_TPU + "window_attention.py:55", counter=("window_attention", "launches"),
        paths=PATHS, headline="stage0 qkv(128, 144, 576) H6 mask bfloat16"),
    "dyn_exp_step": dict(
        route="cuda", source=_PORT + "csrc/dyn_exp_step.cu",
        replaces=_TPU + "dyn_exp_step.py:226", counter=("dyn_exp_step", "launches"),
        paths=PATHS, headline="B24 L20 pos7 bfloat16"),
    "topk": dict(
        route="cuda", source=_PORT + "csrc/topk.cu",
        replaces=_TPU + "topk.py:78", counter=("topk", "launches"),
        paths=PATHS, headline="R24 V10000 k3 float32"),
    "layernorm": dict(
        route="triton", source=_PORT + "ops/layernorm.py",
        replaces=_TPU + "layernorm.py:36", counter=("layernorm", "launches"),
        paths=PATHS, headline="(18432, 192) bfloat16"),
    "patch_embed": dict(
        route="cuda", source=_PORT + "csrc/stage_boundary.cu",
        replaces=_TPU + "stage_boundary.py:100",
        counter=("stage_boundary", "patch_embed_launches"),
        paths=("fused",), headline="x(2, 96, 96, 48) C192 bfloat16"),
    "downsample": dict(
        route="cuda", source=_PORT + "csrc/stage_boundary.cu",
        replaces=_TPU + "stage_boundary.py:179",
        counter=("stage_boundary", "downsample_launches"),
        paths=("fused",), headline="stage0 x(128, 144, 192) bfloat16"),
    "swin_attn_half": dict(
        route="cuda", source=_PORT + "csrc/swin_attn_half.cu",
        replaces=_TPU + "swin_block_fused.py:872",
        counter=("swin_block_fused", "attn_half_launches"),
        paths=("fused",), headline="stage2 x(8, 144, 768) mask trans0to6 bfloat16"),
    "swin_mlp_half": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_half.cu",
        replaces=_TPU + "swin_block_fused.py:1113",
        counter=("swin_block_fused", "mlp_half_launches"),
        paths=("fused",), headline="stage2 x(8, 144, 768) bfloat16"),
    "window_transition": dict(
        route="cuda", source=_PORT + "csrc/window_transition.cu",
        replaces=_TPU + "swin_block_fused.py:625",
        counter=("swin_block_fused", "transition_launches"),
        paths=("fused",), headline="stage0 x(128, 144, 192) 6to0 bfloat16"),
}
# launches of the window-resident kernels in one encode of Swin-L (depths
# 2, 2, 18, 2): one per block of stages 0-2, one per stage boundary, and the
# two single-window blocks of stage 3 on the attention-core kernel
FUSED_ENCODE_LAUNCHES = {"patch_embed": 1, "downsample": 3, "swin_attn_half": 22,
                         "swin_mlp_half": 22, "window_transition": 3, "window_attention": 2}


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.card = ""
        self.errors = {k: 0.0 for k in KERNELS}
        self.times = {}
        self.launches = {}  # path -> kernel -> launches in that path's main-path run
        self.serve = {}  # path -> bf16 Captioner at b8 / beam 3 / L20

    # -- helpers -------------------------------------------------------------
    def check(self, case) -> None:
        """Hold one phase-3 case's kernel against its plain version."""
        from on_device_image_captioning_torch.ops import _cases

        for part, got, want, tol in case.check():
            abs_err, rel_err, ok = _cases.compare(got, want, tol)
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
    def kernels(self):
        torch = self.torch
        from on_device_image_captioning_torch.ops import _cases

        log("phase 3 kernels against their plain versions (on the card; "
            "cases and tolerances from ops/_cases.py)")
        for make in _cases.CASES.values():
            for case in make(self.dev):
                self.check(case)
        torch.cuda.synchronize()

    # -- models ------------------------------------------------------------------
    def model(self, dtype, device, path="pallas"):
        import dataclasses

        torch = self.torch
        from on_device_image_captioning_torch.config import end_expansionnet_v2_coco
        from on_device_image_captioning_torch.models.end_to_end import (
            EndExpansionNetV2, init_weights,
        )

        cfg = end_expansionnet_v2_coco(compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, attention_impl=path))
        model = EndExpansionNetV2(cfg)
        init_weights(model, torch.Generator().manual_seed(SEED))
        return cfg, model.to(device)

    def images(self, n, seed):
        return np.random.default_rng(seed).integers(0, 256, (n, 384, 384, 3), dtype=np.uint8)

    # -- phase 4 ---------------------------------------------------------------
    def main_path(self):
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.ops import _cases

        imgs = self.images(B_SERVE, SEED)
        enc = {}
        for path in PATHS:
            cfg, model = self.model(torch.bfloat16, self.dev, path)
            serve = Captioner(model, cfg, {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE})
            self.serve[path] = serve
            self.counters(reset=True)
            caps, _ = serve.beam_search(imgs)
            torch.cuda.synchronize()
            self.launches[path] = self.counters()
            cap = cfg.captioner
            lengths = [len(c[0]) for c in caps]
            log(f"phase 4 main path, attention_impl={path!r}: Swin-L/384 + d512 captioner, "
                f"V={cap.vocab_size}, b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} bf16; "
                f"lengths {lengths}; launches {self.launches[path]}")
            for row in caps:
                toks = row[0]
                if toks[0] != cap.sos_idx:
                    raise AssertionError(f"caption does not start with SOS: {toks}")
                if not 2 <= len(toks) <= L_SERVE:
                    raise AssertionError(f"caption length {len(toks)} outside [2, {L_SERVE}]")
                if max(toks) >= cap.vocab_size or min(toks) < 0:
                    raise AssertionError(f"token id out of range: {toks}")
            for name, k in KERNELS.items():
                n = self.launches[path][name]
                if (n > 0) != (path in k["paths"]):
                    raise AssertionError(
                        f"kernel {name}: {n} launches on the {path!r} path, which "
                        f"{'runs' if path in k['paths'] else 'does not run'} it")
            enc[path] = serve.forward_enc(imgs)
        self.counters(reset=True)
        self.serve["fused"].forward_enc(imgs)
        torch.cuda.synchronize()
        got = {k: v for k, v in self.counters().items() if k in FUSED_ENCODE_LAUNCHES}
        log(f"  window-resident kernels in one encode: {got}")
        if got != FUSED_ENCODE_LAUNCHES:
            raise AssertionError(f"window-resident launches {got} != {FUSED_ENCODE_LAUNCHES}")
        # The two paths round at other places (q scaled in fp32 or in bf16,
        # probabilities normalized before or after their rounding), and the
        # one-ulp differences compound through 24 blocks and 3 encoder layers
        # into noise on a layer-normalized output (rms 1). So the bf16
        # tolerance of the kernel cases (2e-2) is held at the level of the
        # root mean square, and no single element of the ~6e5 may be off by
        # more than five times that.
        rtol = _cases.TOL[torch.bfloat16][1]
        a, b = enc["fused"].float(), enc["pallas"].float()
        diff, rms = float((a - b).square().mean().sqrt()), float(b.square().mean().sqrt())
        max_abs = float((a - b).abs().max())
        log(f"  bf16 encoder output {tuple(a.shape)}, fused vs pallas path: rms of the "
            f"difference {diff:.3e} on an rms of {rms:.3e} (tol {rtol:g} x rms), "
            f"max_abs={max_abs:.3e} (tol {5 * rtol:g} x rms)")
        if not (diff <= rtol * rms and max_abs <= 5 * rtol * rms):
            raise AssertionError("the two backbone paths disagree at bf16")

    # -- phase 5 ---------------------------------------------------------------
    def self_check(self):
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.decode import cache as dc

        args = {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE}
        cfg, cpu_model = self.model(torch.float32, "cpu")
        cpu = Captioner(cpu_model, cfg, args, device="cpu")
        imgs = self.images(2, SEED + 1)
        cap = cfg.captioner

        def first_step(c_, enc):
            st = dc.init_state(c_.model, cap, enc, L_SERVE)
            sos = torch.full((2,), cap.sos_idx, dtype=torch.int32, device=enc.device)
            return dc.dec_step(c_.model, cap, st, sos, 0, torch.float32)[0]

        with torch.inference_mode():
            enc_c = cpu.forward_enc(imgs)
            lp_c = first_step(cpu, enc_c)
        caps_c, _ = cpu.beam_search(imgs)
        # fp32 through 24 Swin blocks + 3 encoder layers on both sides, only the
        # summation order differs: the tests' tolerance through the stacks
        atol = 1e-4
        for path in PATHS:
            gpu_cfg, gpu_model = self.model(torch.float32, self.dev, path)
            gpu = Captioner(gpu_model, gpu_cfg, args)
            with torch.inference_mode():
                enc_g = gpu.forward_enc(imgs)
                lp_g = first_step(gpu, enc_g)
            enc_err = float((enc_g.cpu() - enc_c).abs().max())
            lp_err = float((lp_g.cpu() - lp_c).abs().max())
            log(f"phase 5 fp32 card kernels ({path!r} path) vs CPU plain path: encoder "
                f"max_abs={enc_err:.3e}, first-step log-probs max_abs={lp_err:.3e} "
                f"(tol atol {atol:g})")
            if not (enc_err <= atol and lp_err <= atol):
                raise AssertionError(f"{path!r} kernel path and plain path disagree at fp32")
            enc_16 = self.serve[path].forward_enc(imgs).float()
            log(f"  bf16 {path!r} path against this fp32 result: rms of the difference "
                f"{float((enc_16 - enc_g).square().mean().sqrt()):.3e}")
            caps_g, _ = gpu.beam_search(imgs)
            agree = total = 0
            for i, (a, b) in enumerate(zip(caps_g, caps_c)):
                a, b = a[0], b[0]
                total += max(len(a), len(b))
                agree += sum(x == y for x, y in zip(a, b))
                if a == b:
                    continue
                t = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
                with torch.inference_mode():
                    prefix = torch.tensor([b[:t]], dtype=torch.int64)
                    logits = cpu_model.forward_dec(enc_c[i:i + 1], prefix, apply_log_softmax=True)
                margin = abs(float(logits[0, t - 1, a[t]] - logits[0, t - 1, b[t]]))
                log(f"  image {i}: captions diverge at step {t}: card {a[t]} vs cpu {b[t]}, "
                    f"top-2 margin {margin:.3e}")
                if margin >= 1e-4:
                    raise AssertionError("captions diverge at more than a near-tie")
            log(f"  token agreement card ({path!r}) vs CPU: {agree}/{total}")
            del gpu, gpu_model
            torch.cuda.empty_cache()

    # -- phase 6 ---------------------------------------------------------------
    def timing(self):
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.ops import _cases

        log(f"phase 6 times, CUDA events, ms per call ({self.card})")
        for make in _cases.CASES.values():
            for case in make(self.dev):
                ms = self.cuda_time(case.run_kernel)
                plain_ms = self.cuda_time(case.run_plain)
                library = self.library_call(case)
                library_ms = None if library is None else self.cuda_time(library)
                peak = BF16_FLOPS if case.matmul and "bfloat16" in case.label else FP32_FLOPS
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

        imgs8 = self.images(B_SERVE, SEED + 2)
        enc_ms = {p: [] for p in PATHS}
        for path in ("pallas", "fused", "fused", "pallas"):
            enc_ms[path].append(self.cuda_time(
                lambda: self.serve[path].forward_enc(imgs8), iters=5, warmup=1))
        for path in PATHS:
            log(f"  encode b{B_SERVE} bf16, attention_impl={path!r}: "
                f"{statistics.mean(enc_ms[path]):.3f} ms (CUDA events, 2 x 5 calls in the order "
                f"pallas, fused, fused, pallas: {[round(t, 3) for t in enc_ms[path]]}) | {self.card}")
        serve = self.serve["pallas"]

        def run(captioner, imgs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            captioner.beam_search(imgs)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    smoke = Smoke(torch)
    smoke.device()
    smoke.build()
    smoke.kernels()
    smoke.main_path()
    smoke.self_check()
    smoke.timing()
    kernels = []
    for name, k in KERNELS.items():
        by_path = {p: smoke.launches[p][name] for p in PATHS}
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
    sys.exit(main())
