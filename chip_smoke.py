#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`on_device_image_captioning_torch`) on one
NVIDIA card: the quickest proof that the port builds, is right and runs.

    python3 chip_smoke.py [[kernel] name ...]

With kernel names (keys of KERNELS, e.g. `kernel swin_attn_bwd swin_mlp_bwd`) only
phases 1-3 and the kernels' part of phase 6 run, for those kernels, and no
result line is printed: the quick check while working on a kernel.

Phases, in order (any failure raises and exits non-zero before the result):

1. Device: card name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compile every kernel of the main path from the sources in the
   checkout (nvcc, all sources at once) and print the seconds.
3. Each kernel against its plain PyTorch version on the card, at main-path
   shapes, in fp32 and bf16, with the tolerance printed beside each check
   (B6 in bf16: with one bf16 ulp of each of its output's two addends, and
   the count of elements that needed it; K1 also at the model-axis shard
   shape of run "parallel_eval", b8 stage 0 on 3 of 6 heads). Every inference kernel is a
   `torch.library` op of the namespace `odic`: `torch.library.opcheck` of
   each on CUDA inputs (ops/_cases.py::opcheck_calls) must pass.
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
   the model (B12's product once per int8 linear outside the window-resident
   stages per encode, once per int8 linear of the decoder per step and for
   the cross K/V once, its scale and int8 x one launch per decode call and
   two per encoder-side call; B13 and B4 once per w8a8 block; B5, B6, B7, B8,
   B16 not at all under w8a8).
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
   SCST (run "scst"): the same model and path, dropout off,
   `train/train_step.py::make_scst_fused_step` with PlainRAdam, 4 images x 5
   samples of up to 20 tokens (the sampler's caches fp32, `step_impl`
   "pallas": K2), the reward the on-card CIDEr-D of
   `train/device_cider.py` over a seeded synthetic corpus (V = 10000 words, 64
   images x 5 random references), three steps. In every step: loss and
   rewards finite, the rewards equal to `train/scst.py::CiderReward`'s (the
   native C++ scorer, use_native="always") within 1e-4, the training kernels
   launched exactly as in an XE step (the encoder ran once), K2 3 times per
   sampling step taken, every kernel outside the run's paths not at all; every
   parameter with a finite gradient; the on-card CIDEr-D of the batch's
   references with a third of their words swapped against the host's.
   Exported engines (runs "export", "export_pallas", "export_w8a8",
   "export_greedy"; `deploy/aot.py`, full width): run "fused"'s bf16 model
   (form D, full depth), and at Swin depths (2, 2, 2, 2) the "pallas" and
   "w8a8" forms and form D's greedy (beam 1), at b8 / beam 3 / L20, each
   exported with bf16 weights, saved, loaded back and run on the serve
   images: tokens and lengths equal, token for token, to eager
   `api.Captioner`'s on the same weights rounded through bf16, and the
   launches equal to that eager run's. Run "export" prints
   the export seconds, the artifact's bytes beside 2 bytes a parameter and
   the walls per batch of engine and eager (medians of 5, in turns).
   Pruning (run "prune"): run "fused"'s full-width weights pruned by 0.33
   twice on the host (`deploy/pruning.py`), `save_sparse`, then
   `cli/evaluate.py --load_pruned` on the card over run "eval"'s split
   written as JPEGs (L74): predictions equal to `evaluate_split`'s over the
   same pruned weights in memory; the GLOBAL sparsity and the npz's bytes
   printed.
   Evaluation (runs "eval", "eval_w8a8", "features", "eval_features"; no
   image or HDF5 file is read: the images are seeded uint8 arrays handed in
   through `load_images`, the stores kept in memory): a synthetic test split
   of 12 images with 5 references of random words of a V = 10000 vocabulary.
   "eval": `cli/evaluate.py::evaluate_split` on the bf16 model of run
   "fused" with the "pallas" step, batches of 8 (the second padded), beam 3
   / L20, all five metrics (native METEOR and SPICE): every image predicted,
   the predictions equal to `api.Captioner.beam_search`'s on the same padded
   batches, every score finite, the launches per batch equal to Captioner's
   and to the serve runs' counts for the path. "eval_w8a8": the w8a8 model
   of run "w8a8", one batch of 8, its launches equal to that serve run's.
   "features": the extractor of `cli/generate_features.py` with the bf16
   "pallas" backbone of run "pallas" into float32 and float16 stores: the
   float32 store equal to the run's encoder features, the float16 one within
   F16_FEATURES_TOL.
   "eval_features": `evaluate_split` features in over the float32 store on
   the caption head of the same weights (fp32 caches: K2's fp32 form). In
   every run each kernel outside the run's paths is launched not at all.
   The training CLI (run "train_cli"): `cli/train.py` as users run it, at
   full width (Swin-L/384 + d512, V = 10000 through a --vocab_path JSON,
   bf16, "fused", b4) on 8 seeded 384^2 JPEGs written with PIL into a
   temporary directory (6 train, 2 val; 5 random references each): an XE
   epoch with a checkpoint; a resume to two epochs with --prefetch 2 (its
   first batch the loader's 8th, the optimizer's count restored); from that
   checkpoint (a phase flip) an SCST epoch with the on-card reward and one
   with the host reward, --prefetch 2, the eval hook on val at beam 3 in
   each; one XE iteration with --distributed (NCCL at world size 1) and one
   with --remat, each against the same iteration without (the loss, the
   weights and both Adam moments bit-equal); the evaluate CLI on the last native checkpoint, its
   captions equal to `api.Captioner`'s on the same weights. Every CLI
   iteration launches the training kernels exactly as run "train" does
   (TRAIN_LAUNCHES; the SCST steps too, the encoder once) and, in XE, no
   kernel outside the run's paths. Prints the CLI's s/it at --prefetch 0
   and 2 and the peak device memory of one iteration with and without
   --remat.
   Parallel evaluation (run "parallel_eval"): `cli/evaluate.py
   --distributed` in two worker processes on the one card, each joining a
   gloo group itself, Swin-L/384 + d512 at Swin depths (2, 2, 2, 2), the
   "pallas" backbone and step, run "eval"'s 12 images as JPEGs, b8 / beam 3
   / L20: `--n_model 1` (two data ranks) and `--n_model 2` (one model group,
   every FF, Swin qkv / proj / MLP, the vocabulary projection and embedding
   cut over it) at fp32 with TF32 off, predictions equal one process's
   `evaluate_split` token for token and the first step's log-probs within
   1e-4; `--n_model 2` at bf16 held by its scores. Each rank's launches
   counted (K1, K2, K3, K4 only). Prints the two-process img/s beside one
   process's.
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
   tolerance. SCST held to the plain path: one shared-encoder step at fp32,
   depths (2, 2, 2, 2), 2 images x 5 samples, the same Gumbel noise on both
   sides and a reward that is an integer function of the tokens: the sampled
   tokens and rewards equal, the loss and log-prob sum within 2e-4; every
   gradient held under the XE check's ReLU-sign rule and tolerances: the card
   under the CPU's ReLU signs within the imposed tolerance (5e-5), the
   free-running card within the free one against the CPU under the card's
   signs; the ReLU flips counted and bounded.
   Evaluation held to the plain path: 2 images through the features-in
   evaluation at fp32 (the caption head of the fp32 model's weights, two
   images' features of run "features"'s store) on the card and on the CPU:
   tokens equal (the near-tie rule), beam log-probs within 1e-4;
   `compute_evaluation_loss` on 2 images end to end at fp32, the "fused" card
   model against the CPU's plain path, within 1e-4 relative.
   The bf16 backbone at full depth: the features (2, 144, 1536) of the
   "fused" runs (default modes, and every stage on the halves) against the
   "pallas" run's, same weights and images; relative RMS and max printed, the
   relative RMS held to BF16_FEATURES_REL_RMS (`cli/encode_turns.py` compares
   the same reading between two checkouts).
6. Times: each kernel against its plain version, its bound (the least time
   the card could take, from the case's bytes and operations) and, where one
   PyTorch call computes the same function, that call (CUDA events); B6
   against B4 + B5 at each main-path shape of stages 0 and 1 (ops/_cases.py
   MAIN_PATH_BLOCKS; the kernels line lists each kernel's main-path cases);
   B12 as
   the whole call and as its product alone on the int8 x; the shared bf16
   product of B4 and B5 alone at the four stage-2 products of a b8
   encode, beside `F.linear` on the same tensors (a yardstick); B13's two
   int8 products alone at its four main-path shapes (ops/_cases.py
   MAIN_PATH_A8), beside `torch._int_mm` on the same int8 operands (a
   yardstick); B8 (bf16) at B = 2 and at its six main-path shapes
   (ops/_cases.py MAIN_PATH_MERGES): its launch plan (route, tile and K
   split), the whole call, its product alone on what its first launch left
   in scratch (the row statistics, or the normalized rows), and
   `F.linear` on the same normalized bf16 rows (a yardstick); the training
   backwards' product alone at the nine products of B9c and B9b
   at the XE step's b4 shapes of stages 0-2, beside `torch.matmul` (a
   yardstick), and the CUDA launches in one call of B9c and of B9b; K3 at
   each of its cases in every cluster size the kernel takes (1 to 16 CTAs a
   row), each held exactly to the plain version, the plan's size marked;
   encode ms of the three backbone forms; decode ms per step of both step paths;
   end-to-end img/s at b8/beam 3/L20 and p50 latency at b1/beam 5/L74, bf16,
   on the default path; encode ms of the w8a8 model against the "fused"
   bf16 one in turns, its decode ms per step and img/s at b8; ms per XE step at b4 bf16 with its split into
   forward, backward and optimizer, and the step's peak device memory; img/s
   of the evaluation loops ("eval", "eval_features": `evaluate_split` against
   `api.Captioner.beam_search` on the same batches, in turns; the scoring
   timed apart) and of `generate_features` into float32 and float16 stores in
   turns; ms per SCST step (b4 x 5 samples / L20, bf16) with its split into encoder forward,
   sampling, reward, re-score with backward and optimizer, and its peak
   device memory.

The next-to-last line is {"kernels": [...]} and the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import json
import re
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
TRAIN_CLI = "train_cli"  # phase 4: cli/train.py as users run it (XE, resume, SCST, DDP)
SCST = "scst"  # the SCST run of phase 4: shared-encoder SCST steps on the "fused" path
# quantized serving runs on the "fused" path: name -> (quantize_model mode, step_impl)
QUANT_RUNS = {"w8a8": ("w8a8", "pallas"), "w8": ("w8", "pallas_fused")}
Q_RUNS = tuple(QUANT_RUNS)
B_TRAIN, L_TRAIN, TRAIN_STEPS, TRAIN_LR = 4, 20, 4, 2e-3
# SCST: images, samples an image, tokens a sample, steps; the reward corpus's
# images and references an image (random words of the V = 10000 vocabulary)
B_SCST, SCST_SAMPLES, L_SCST, SCST_STEPS = 4, 5, 20, 3
SCST_IMAGES, SCST_REFS = 64, 5
# run "train_cli": a corpus of CLI_TRAIN + CLI_VAL seeded JPEGs of 384^2 with
# CLI_REFS random references each (b4: 7 XE batches an epoch, one SCST
# batch), the learning rate after a one-iteration warmup; the data-parallel
# (world size 1, NCCL) and --remat iterations against the plain one run the
# same arithmetic on the same kernels: loss, weights and both Adam moments
# are held bit-equal
CLI_TRAIN, CLI_VAL, CLI_REFS, CLI_LR = 6, 2, 5, 1e-4
# evaluation runs of phase 4 (`cli/evaluate.py::evaluate_split` and the
# feature extractor of `cli/generate_features.py`): a synthetic test split of
# N_EVAL seeded images with EVAL_REFS random references each, in batches of
# B_SERVE (the last one padded), beam 3 / L20. "eval": the bf16 "fused" model
# of run "fused" on the "pallas" step; "eval_w8a8": the w8a8 model of run
# "w8a8", one batch; "features": the bf16 "pallas" backbone of run "pallas"
# into float32 and float16 stores; "eval_features": the caption head of the
# same weights over the float32 store (fp32 caches). Launch counts per batch.
EVAL, EVAL_A8, FEATURES, EVAL_FEATURES = "eval", "eval_w8a8", "features", "eval_features"
N_EVAL, EVAL_REFS = 12, 5
EVAL_METRICS = ("bleu", "meteor", "rouge", "cider", "spice")
# the float16 store against the float32 one, as tests/test_cli_integration.py
# holds them on the CPU
F16_FEATURES_TOL = 2e-2
# phase 5's fp32 gradients of the training kernel path against the CPU's plain
# path, per parameter group: free-running, and with the CPU's ReLU signs
# imposed on the card's caption head (Smoke.train_check says why)
GRAD_FREE_TOLS = {"swin_transf.": 2e-4, "caption head": 1e-3}
GRAD_SAME_TOLS = {"swin_transf.": 5e-5, "caption head": 5e-5}
# published peaks of one H100 SXM (dense): device memory bytes/s; bf16 matrix
# products on the tensor cores; fp32 outside them
HBM_BYTES_S, BF16_FLOPS, FP32_FLOPS, INT8_OPS = 3.35e12, 989e12, 67e12, 1979e12
# phase 5: the bf16 backbone features of the "fused" forms may depart from the
# "pallas" form's by this relative RMS at most: 1.5 times what the shared
# product's earlier (wmma) design read on an H100 (1.4051e-2; the wgmma design
# reads the same, PERF.md)
BF16_FEATURES_REL_RMS = 2.1e-2
_TPU = "on_device_image_captioning_tpu/ops/"
_PORT = "on_device_image_captioning_torch/"
# labels of the cases at a main-path shape of their own (ops/_cases.py): the
# kernels line lists their times
MAIN_PATH_LABEL = re.compile(r"b\d+ (stage\d|decode|encoder|sampling) ")
# kernel -> route, source, the TPU kernel it replaces, (ops module, launch
# counter), the runs that launch it, and the phase-6 case whose times go into
# the {"kernels": ...} line
KERNELS = {
    "window_attention": dict(
        route="cuda", source=_PORT + "csrc/window_attention.cu",
        replaces=_TPU + "window_attention.py:55", counter=("window_attention", "launches"),
        paths=ALL_RUNS + Q_RUNS + (EVAL, EVAL_A8, FEATURES),
        headline="stage0 qkv(128, 144, 576) H6 mask bfloat16"),
    "dyn_exp_step": dict(
        route="cuda", source=_PORT + "csrc/dyn_exp_step.cu",
        replaces=_TPU + "dyn_exp_step.py:226", counter=("dyn_exp_step", "launches"),
        paths=("pallas", "fused_halves") + Q_RUNS + (SCST, EVAL, EVAL_A8, EVAL_FEATURES),
        headline="B24 L20 pos7 bfloat16"),
    "topk": dict(
        route="cuda", source=_PORT + "csrc/topk.cu",
        replaces=_TPU + "topk.py:78", counter=("topk", "launches"),
        paths=ALL_RUNS + Q_RUNS + (EVAL, EVAL_A8, EVAL_FEATURES),
        headline="R24 V10000 k3 float32"),
    "layernorm": dict(
        route="cuda", source=_PORT + "csrc/layernorm.cu",
        replaces=_TPU + "layernorm.py:36", counter=("layernorm", "launches"),
        paths=ALL_RUNS + (TRAIN, TRAIN_CLI) + Q_RUNS + (SCST, EVAL, EVAL_A8, FEATURES,
                                                     EVAL_FEATURES),
        headline="(18432, 192) bfloat16"),
    "patch_embed": dict(
        route="cuda", source=_PORT + "csrc/stage_boundary.cu",
        replaces=_TPU + "stage_boundary.py:100",
        counter=("stage_boundary", "patch_embed_launches"),
        paths=WINDOW_RUNS + (EVAL,), headline="x(2, 96, 96, 48) C192 bfloat16"),
    "downsample": dict(
        route="cuda", source=_PORT + "csrc/stage_boundary.cu",
        replaces=_TPU + "stage_boundary.py:179",
        counter=("stage_boundary", "downsample_launches"),
        paths=WINDOW_RUNS + (EVAL,), headline="stage0 x(128, 144, 192) bfloat16"),
    "swin_attn_half": dict(
        route="cuda", source=_PORT + "csrc/swin_attn_half.cu",
        replaces=_TPU + "swin_block_fused.py:872",
        counter=("swin_block_fused", "attn_half_launches"),
        paths=WINDOW_RUNS + Q_RUNS + (EVAL, EVAL_A8),
        headline="stage2 x(8, 144, 768) mask trans0to6 bfloat16"),
    "swin_mlp_half": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_half.cu",
        replaces=_TPU + "swin_block_fused.py:1113",
        counter=("swin_block_fused", "mlp_half_launches"),
        paths=WINDOW_RUNS + ("w8", EVAL), headline="stage2 x(8, 144, 768) bfloat16"),
    "window_transition": dict(
        route="cuda", source=_PORT + "csrc/window_transition.cu",
        replaces=_TPU + "swin_block_fused.py:625",
        counter=("swin_block_fused", "transition_launches"),
        paths=WINDOW_RUNS + (TRAIN, TRAIN_CLI) + Q_RUNS + (SCST, EVAL, EVAL_A8),
        headline="stage0 x(128, 144, 192) 6to0 bfloat16"),
    "swin_block": dict(
        route="cuda", source=_PORT + "csrc/swin_block.cu",
        replaces=_TPU + "swin_block_fused.py:677",
        counter=("swin_block_fused", "block_launches"),
        paths=("fused", "w8", EVAL),
        headline="stage0 x(128, 144, 192) mask trans0to6 bfloat16"),
    "dyn_exp_cross_step": dict(
        route="cuda", source=_PORT + "csrc/dyn_exp_step.cu",
        replaces=_TPU + "dyn_exp_step.py:502",
        counter=("dyn_exp_step", "cross_launches"),
        paths=("fused",), headline="B24 L20 pos7 bfloat16"),
    "swin_block_train": dict(
        route="cuda", source=_PORT + "csrc/swin_block.cu",
        replaces=_TPU + "swin_block_fused.py:1285",
        counter=("swin_block_fused", "block_train_launches"),
        paths=(TRAIN, SCST, TRAIN_CLI), headline="stage0 x(128, 144, 192) mask bfloat16"),
    "swin_attn_bwd": dict(
        route="cuda", source=_PORT + "csrc/swin_attn_bwd.cu",
        replaces=_TPU + "swin_block_fused.py:2063",
        counter=("swin_block_fused", "attn_bwd_launches"),
        paths=(TRAIN, SCST, TRAIN_CLI), headline="stage0 x(128, 144, 192) mask bfloat16"),
    "swin_mlp_bwd": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_bwd.cu",
        replaces=_TPU + "swin_block_fused.py:1547",
        counter=("swin_block_fused", "mlp_bwd_launches"),
        paths=(TRAIN, SCST, TRAIN_CLI), headline="stage0 x(128, 144, 192) bfloat16"),
    "swin_attn_half_train": dict(
        route="cuda", source=_PORT + "csrc/swin_attn_half.cu",
        replaces=_TPU + "swin_block_fused.py:2274",
        counter=("swin_block_fused", "attn_half_train_launches"),
        paths=(TRAIN, SCST, TRAIN_CLI), headline="stage2 x(8, 144, 768) mask bfloat16"),
    "swin_mlp_half_train": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_half.cu",
        replaces=_TPU + "swin_block_fused.py:2396",
        counter=("swin_block_fused", "mlp_half_train_launches"),
        paths=(TRAIN, SCST, TRAIN_CLI), headline="stage2 x(8, 144, 768) bfloat16"),
    "quant_matmul": dict(
        route="cuda", source=_PORT + "csrc/quant_matmul.cu",
        replaces=_TPU + "quant_matmul.py:48", counter=("quant_matmul", "launches"),
        paths=("w8a8", EVAL_A8), headline="stage3 fc1 x(288, 1536) N6144 float32"),
    "quantize_act": dict(
        route="cuda", source=_PORT + "csrc/quant_matmul.cu",
        replaces=_TPU + "quant_matmul.py:48", counter=("quant_matmul", "quantize_launches"),
        paths=("w8a8", EVAL_A8), headline="x(288, 1536) float32 dynamic"),
    "swin_mlp_half_a8": dict(
        route="cuda", source=_PORT + "csrc/swin_mlp_half_a8.cu",
        replaces=_TPU + "swin_block_fused.py:1076",
        counter=("swin_block_fused", "mlp_half_a8_launches"),
        paths=("w8a8", EVAL_A8), headline="stage2 x(8, 144, 768) bfloat16"),
}
# exported engines of phase 4 (`deploy/aot.py`): run -> (the serve run whose
# bf16 model it exports, greedy, Swin depths: None = the serve run's own
# model at full depth; else a model of that run's form and width at these
# depths, to keep the script's time); each engine's launches equal the eager
# Captioner's on the same model (random weights emit no EOS, so the eager
# decode runs every step too)
SHALLOW = (2, 2, 2, 2)
EXPORT_RUNS = {"export": ("fused", False, None), "export_pallas": ("pallas", False, SHALLOW),
               "export_w8a8": ("w8a8", False, SHALLOW), "export_greedy": ("fused", True, SHALLOW)}
EXPORT_REPEATS = 5  # engine and eager walls of run "export": medians of this many, in turns
# run "prune": the "fused" run's weights pruned twice by PRUNE_AMOUNT, then the
# evaluate CLI (--load_pruned) over run "eval"'s split written as JPEGs, at
# the model's max_seq_len, against evaluate_split over the same weights: the
# kernels of run "eval"
PRUNE, PRUNE_AMOUNT, PRUNE_ROUNDS = "prune", 0.33, 2
# run "parallel_eval": `cli/evaluate.py --distributed` in two processes on the
# one card (gloo), Swin-L/384 + d512 at Swin depths SHALLOW, V = 10000, the
# "pallas" backbone and step, beam 3 / L20, over run "eval"'s 12 images
# written as JPEGs, in global batches of 8. Forms: name -> (--n_model, bf16);
# the fp32 forms' predictions equal one process's token for token, the bf16
# form's scores one process's within PARALLEL_BF16_SCORE_TOL. The launches
# of the run are rank 0's of the fp32 tensor-parallel form ("tp");
# "parallel_eval_dp" those of the data-parallel one.
PARALLEL_EVAL, PARALLEL_DP = "parallel_eval", "parallel_eval_dp"
PARALLEL_FORMS = {"dp": (1, False), "tp": (2, False), "tp_bf16": (2, True)}
PARALLEL_METRICS = ("bleu", "cider")
PARALLEL_LOGPROB_TOL = 1e-4  # the first step's log-probs, tensor parallel against one process
PARALLEL_BF16_SCORE_TOL = 0.05  # bf16 near-ties move captions: held at the metric level
PARALLEL_TIMEOUT = 600  # seconds a form's two workers may take
# passes over the split (--beam_sizes 3 3): each process's first pass loads the
# kernels and warms cuBLAS, so the img/s compared are the last pass's
PARALLEL_PASSES = 2
for _k in KERNELS.values():
    _k["paths"] += tuple(r for r, (src, *_) in EXPORT_RUNS.items() if src in _k["paths"])
    _k["paths"] += (PRUNE,) if EVAL in _k["paths"] else ()
for _name in ("window_attention", "dyn_exp_step", "topk", "layernorm"):
    KERNELS[_name]["paths"] += (PARALLEL_EVAL, PARALLEL_DP)
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


class MemoryStore:
    """A feature store kept in memory: `write` as `data/features_io.py::
    FeatureStore.write` does, `read_batch` as its `read_batch` (float32,
    right-padded on the token dimension)."""

    def __init__(self):
        self.data = {}

    def write(self, img_id, features):
        self.data[img_id] = np.asarray(features)

    def read_batch(self, img_ids):
        feats = [self.data[i].astype(np.float32) for i in img_ids]
        n = max(f.shape[0] for f in feats)
        out = np.zeros((len(feats), n, feats[0].shape[-1]), np.float32)
        for i, f in enumerate(feats):
            out[i, :f.shape[0]] = f
        return out, [n - f.shape[0] for f in feats]


def log(msg: str) -> None:
    print(msg, flush=True)


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.card = ""
        self.errors = {k: 0.0 for k in KERNELS}
        self.times = {}
        self.case_times = {}  # kernel -> the device times of its main-path cases (phase 6)
        self.launches = {}  # run -> kernel -> launches in that main-path run
        self.serve = {}  # run -> bf16 Captioner at b8 / beam 3 / L20
        self.trainer = None  # (cfg, model, optimizer, step, batch, generator) of the training run
        self.feature_store = None  # run "features"'s float32 store (phase 4), read by phase 5
        self.evals = None  # what phase 6 times of the evaluation runs
        self.scst = None  # (model, step, batch, ref tables, generator) of the SCST run

    # -- helpers -------------------------------------------------------------
    def check(self, case) -> None:
        """Hold one phase-3 case's kernel against its plain version."""
        from on_device_image_captioning_torch.ops import _cases

        for part, got, want, tol in case.check():
            abs_err, rel_err, ok = _cases.compare(got, want, tol)
            if "int8" not in part:  # int8 parts count codes and steps, not errors of values
                self.errors[case.kernel] = max(self.errors[case.kernel], abs_err)
            slack = "" if len(tol) < 3 else (
                f" + one bf16 ulp of each addend (needed by "
                f"{_cases.slack_used(got, want, tol)} of {got.numel()} elements)")
            log(f"  [{'ok' if ok else 'FAIL'}] {case.kernel} {case.label} {part}: "
                f"max_abs={abs_err:.3e} max_rel={rel_err:.3e} "
                f"tol=atol {tol[0]:g} + rtol {tol[1]:g}{slack}")
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

    def graph_time(self, fn, iters=20):
        """Device ms per call of fn, without the host's cost: `iters` calls
        captured in one CUDA graph, replayed three times between CUDA events.
        None where fn cannot be captured."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for _ in range(iters):
                    fn()
        except RuntimeError as err:  # a yardstick only: report, do not fail
            torch.cuda.synchronize()
            log(f"  not captured in a CUDA graph: {str(err).splitlines()[0]}")
            return None
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * iters)

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
        from on_device_image_captioning_torch.ops import _build

        start = time.perf_counter()
        _build.compile_all()
        for src in sorted(_build.CSRC_DIR.glob("*.cu")):
            _build.load_cuda_library(src.stem)
        total = time.perf_counter() - start
        per = ", ".join(f"{k} {v:.1f}s" for k, v in _build.build_seconds.items())
        log(f"phase 2 build: {total:.1f}s in all (nvcc, all sources at once: {per})")

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
    def model(self, dtype, device, run="pallas", seed=SEED, depths=None):
        """(cfg, model, step_impl) of a main-path run, seeded random weights
        (Swin-L's depths unless `depths` cuts them)."""
        import dataclasses

        torch = self.torch
        from on_device_image_captioning_torch.config import end_expansionnet_v2_coco
        from on_device_image_captioning_torch.models.end_to_end import (
            EndExpansionNetV2, init_weights,
        )

        path, halves, step_impl = RUNS[run]
        cfg = end_expansionnet_v2_coco(compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(
            cfg.swin, attention_impl=path, depths=depths or cfg.swin.depths))
        modes = {i: "halves" for i in range(cfg.swin.num_layers)} if halves else None
        model = EndExpansionNetV2(cfg, modes)
        init_weights(model, torch.Generator().manual_seed(seed))
        return cfg, model.to(device), step_impl

    def quant_model(self, dtype, device, mode, seed=SEED, depths=None):
        """(cfg, model) of a quantized run: the "fused" model of run "fused"
        with every linear quantized (`quantize_model`), built on the CPU and
        then moved, so the card and the CPU hold the same int8 weights."""
        from on_device_image_captioning_torch.deploy.quantization import (
            quantize_model, quantized_size_bytes,
        )

        cfg, model, _ = self.model(dtype, "cpu", "fused", seed, depths)
        before = quantized_size_bytes(model)
        quantize_model(model, mode)
        return cfg, model.to(device), (before, quantized_size_bytes(model))

    def quant_launches(self, model, steps, batch=B_SERVE, beam=BEAM_SERVE):
        """The launches one encode and one decode of `steps` steps must make,
        derived from the quantized model: (encode counts, decode counts). B12's
        product is one launch per int8 linear; its scale and int8 x one or two
        (`quantize_launch_count` of the call's rows x K)."""
        from on_device_image_captioning_torch.deploy.quantization import is_a8
        from on_device_image_captioning_torch.ops import quant_matmul as qm

        def quantize(mods, rows):  # launches of the scale / int8 x kernels
            return sum(qm.quantize_launch_count(rows * m.w_q.shape[1], m.x_scale is not None)
                       for m in mods if is_a8(m))

        swin = model.swin_transf
        multi = [l for l in swin.layers if l.blocks[0].res > l.blocks[0].window]
        single = [b for l in swin.layers if l not in multi for b in l.blocks]
        blocks = [b for l in multi for b in l.blocks]
        tokens = batch * swin.layers[-1].blocks[0].res ** 2  # rows of stage 3 and the caption head
        named = dict(model.named_modules())
        head = [m for n, m in named.items()
                if n.split(".")[0] in ("input_linear", "encoders", "enc_reduce_group")]
        single_lin = [m for b in single for m in (b.attn.qkv, b.attn.proj, b.mlp.fc1, b.mlp.fc2)]
        downs = [l for l in swin.layers if l.downsample is not None]
        b12 = is_a8(swin.patch_embed.proj) + sum(is_a8(l.downsample.reduction) for l in downs)
        b12 += sum(is_a8(m) for m in single_lin + head)
        quant = quantize([swin.patch_embed.proj], batch * swin.layers[0].blocks[0].res ** 2)
        quant += sum(quantize([l.downsample.reduction], batch * (l.blocks[0].res // 2) ** 2)
                     for l in downs)
        quant += quantize(single_lin + head, tokens)
        encode = {
            "quant_matmul": b12, "quantize_act": quant,
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
        step_lin = [m for m in dec if all(m is not c for c in cross)]
        decode = {"quant_matmul": sum(is_a8(m) for m in cross) + steps * per_step,
                  "quantize_act": quantize(cross, tokens) + steps * quantize(step_lin, batch * beam),
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

    def export_path(self):
        """Phase 4, the exported engines (runs of EXPORT_RUNS): a serve run's
        bf16 model (or one of its form at cut depths) through
        `deploy/aot.py::export_artifact` (bf16 weights), saved, loaded back
        with `load_artifact` and run on the serve images; its tokens and
        lengths equal, token for token, eager `api.Captioner`'s on the same
        model with its weights rounded through bf16 (what the artifact
        ships), and so do its launches. Run "export": export seconds,
        artifact bytes beside two bytes a parameter, and the walls per batch
        of engine and eager."""
        import copy
        import os
        import shutil
        import tempfile

        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.config import DecodeConfig
        from on_device_image_captioning_torch.deploy import aot

        imgs = self.images(B_SERVE, SEED)
        x = torch.from_numpy(imgs).to(self.dev)
        for run, (src, greedy, depths) in EXPORT_RUNS.items():
            serve = self.serve[src]
            if depths is not None:  # the source run's form and width, cut in depth
                if src in QUANT_RUNS:
                    cfg, model, _ = self.quant_model(torch.bfloat16, self.dev,
                                                     QUANT_RUNS[src][0], depths=depths)
                else:
                    cfg, model, _ = self.model(torch.bfloat16, self.dev, src, depths=depths)
                serve = Captioner(model, cfg, {}, step_impl=serve.step_impl)
            cfg, cap = serve.cfg, serve.cap_cfg
            beam = 1 if greedy else BEAM_SERVE
            dcfg = DecodeConfig(beam_size=BEAM_SERVE, how_many_outputs=1, max_seq_len=L_SERVE,
                                sos_idx=cap.sos_idx, eos_idx=cap.eos_idx)
            root = tempfile.mkdtemp(prefix="engine_")
            try:
                torch.cuda.synchronize()
                start = time.perf_counter()
                aot.export_artifact(root, serve.model, cfg, dcfg, B_SERVE, greedy=greedy,
                                    step_impl=serve.step_impl)
                export_s = time.perf_counter() - start
                size = os.path.getsize(os.path.join(root, aot.GRAPH))
                weights = aot.weight_bytes(root)
                manifest = aot.load_manifest(root)
                call, params = aot.load_artifact(root)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            n_params = sum(t.numel() for t in serve.model.state_dict().values()
                           if isinstance(t, torch.Tensor) and t.is_floating_point())
            self.counters(reset=True)
            toks, lens = call(params, x)
            torch.cuda.synchronize()
            self.launches[run] = self.counters()
            ref_model = aot.round_to_shipped(copy.deepcopy(serve.model), cfg)
            ref = Captioner(ref_model, cfg, {"beam_size": beam, "beam_max_seq_len": L_SERVE},
                            step_impl=serve.step_impl)
            self.counters(reset=True)
            caps, _ = ref.beam_search(imgs)
            torch.cuda.synchronize()
            eager = self.counters()
            got = [toks[i, :int(lens[i])].tolist() for i in range(B_SERVE)]
            want = [c[0] for c in caps]
            if got != want or [len(c) for c in want] != lens.tolist():
                raise AssertionError(f"run {run!r}: the loaded engine's captions {got} differ "
                                     f"from eager Captioner's {want}")
            self.check_paths(run, self.launches[run])
            if self.launches[run] != eager:
                raise AssertionError(f"run {run!r}: launches {self.launches[run]} != eager "
                                     f"Captioner's {eager}")
            log(f"phase 4 exported engine, run {run!r}: run {src!r}'s form "
                f"(attention_impl={cfg.swin.attention_impl!r}, step_impl={serve.step_impl!r}), "
                f"Swin depths {cfg.swin.depths}, b{B_SERVE}/beam {beam}/L{L_SERVE}, manifest "
                f"{manifest}; exported, saved and "
                f"loaded in {export_s:.1f} s; graph.pt2 {size} bytes, of which weights and "
                f"constants {weights} (2 bytes x {n_params} floating parameters = "
                f"{2 * n_params}); tokens and lengths equal to eager Captioner's on the same "
                f"bf16-rounded weights ({B_SERVE} captions, lengths {lens.tolist()}); launches "
                f"equal to eager Captioner's: {eager}")
            if run == "export":
                walls = {"engine": [], "eager": []}
                for _ in range(EXPORT_REPEATS):
                    for what, fn in (("engine", lambda: call(params, x)),
                                     ("eager", lambda: ref.decode(ref.forward_enc(x)))):
                        torch.cuda.synchronize()
                        start = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        walls[what].append(1e3 * (time.perf_counter() - start))
                med = {k: statistics.median(v) for k, v in walls.items()}
                log(f"  run {run!r}: wall per batch of b{B_SERVE} (host clock, medians of "
                    f"{EXPORT_REPEATS}, in turns): engine {med['engine']:.3f} ms, eager "
                    f"Captioner {med['eager']:.3f} ms (runs: engine "
                    f"{[round(v, 3) for v in walls['engine']]}, eager "
                    f"{[round(v, 3) for v in walls['eager']]}) | {self.card}")
            del call, params, ref, ref_model, serve
            torch.cuda.empty_cache()

    def prune_path(self):
        """Phase 4, run "prune": the "fused" run's full-width weights pruned
        by PRUNE_AMOUNT PRUNE_ROUNDS times on the host (`deploy/pruning.py`),
        `save_sparse`, then `cli/evaluate.py --load_pruned` on the card over
        run "eval"'s synthetic split written as JPEGs (bf16, "fused", the
        "pallas" step, beam 3, batches of 8, at the model's max_seq_len); its
        predictions must equal `evaluate_split`'s over the same pruned
        weights in memory. Prints the GLOBAL sparsity and the npz's size."""
        import contextlib
        import os
        import shutil
        import tempfile

        torch = self.torch
        from on_device_image_captioning_torch.cli import evaluate as eval_cli
        from on_device_image_captioning_torch.data.datasets import load_coco_karpathy
        from on_device_image_captioning_torch.deploy import pruning
        from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
        from on_device_image_captioning_torch.params.convert import w_leaf_names

        serve = self.serve["fused"]
        cfg, cap = serve.cfg, serve.cap_cfg
        sd = {k: v.cpu() if isinstance(v, torch.Tensor) else v
              for k, v in serve.model.state_dict().items()}
        names = w_leaf_names(serve.model)
        start = time.perf_counter()
        for _ in range(PRUNE_ROUNDS):
            sd = pruning.global_l1_prune(sd, names, PRUNE_AMOUNT)
        prune_s = time.perf_counter() - start
        report = pruning.sparsity_report(sd)
        dataset, load_images = self.eval_split(cap)
        root = tempfile.mkdtemp(prefix="prune_")
        try:
            npz = os.path.join(root, "pruned.npz")
            start = time.perf_counter()
            pruning.save_sparse(npz, sd)
            save_s = time.perf_counter() - start
            ann, vocab_path = self.write_split(root, dataset, load_images, cfg.swin.img_size)
            dump = os.path.join(root, "preds.json")
            self.counters(reset=True)
            start = time.perf_counter()
            with contextlib.redirect_stdout(open(os.devnull, "w")):
                rc = eval_cli.main(["--annotations", ann, "--images_path", root,
                                    "--vocab_path", vocab_path, "--load_path", npz, "--load_pruned",
                                    "--split", "test", "--beam_sizes", str(BEAM_SERVE),
                                    "--batch_size", str(B_SERVE),
                                    "--max_seq_len", str(cap.max_seq_len), "--bf16",
                                    "--metrics", "bleu", "cider", "--dump_predictions", dump,
                                    "--device", "cuda"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - start
            self.launches[PRUNE] = self.counters()
            if rc != 0:
                raise AssertionError(f"cli.evaluate.main --load_pruned returned {rc}")
            with open(dump) as f:
                got = json.load(f)[str(BEAM_SERVE)]
            files = load_coco_karpathy(ann, root, vocab=dataset.vocab)
            model = EndExpansionNetV2(cfg)
            model.load_state_dict(sd)
            model.to(self.dev).eval().prepare_inference()
            _, want = eval_cli.evaluate_split(
                model, cfg, files, "test", BEAM_SERVE, B_SERVE, cap.max_seq_len, verbose=False,
                metrics=("bleu", "cider"))
            npz_bytes = os.path.getsize(npz)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        want = {str(k): v for k, v in want.items()}
        if got != want:
            raise AssertionError(f"run {PRUNE!r}: the CLI's predictions {got} differ from "
                                 f"evaluate_split's {want}")
        self.check_paths(PRUNE, self.launches[PRUNE])
        dense = sum(t.numel() * t.element_size() for t in sd.values()
                    if isinstance(t, torch.Tensor))
        log(f"phase 4 pruning, run {PRUNE!r}: {PRUNE_ROUNDS} rounds of global L1 at "
            f"{PRUNE_AMOUNT} over {len(names)} weights of run 'fused''s model on the host "
            f"({prune_s:.1f} s); GLOBAL sparsity {report['GLOBAL']:.4f}; save_sparse "
            f"{npz_bytes} bytes ({save_s:.1f} s) against {dense} dense; cli.evaluate "
            f"--load_pruned over {len(got)} images (bf16, 'fused', 'pallas' step, beam "
            f"{BEAM_SERVE}, L{cap.max_seq_len}) in {cli_s:.1f} s: predictions equal "
            f"evaluate_split's over the same weights in memory; launches {self.launches[PRUNE]}")
        del model
        torch.cuda.empty_cache()

    @staticmethod
    def write_split(root, dataset, load_images, size):
        """Run "eval"'s synthetic test split as files in `root`, as a user
        hands them to the evaluate CLI: JPEGs of its seeded images under
        <root>/v/img/ (<images_path>/<filepath>/img/<file>), a Karpathy json
        and the vocabulary json. Returns (annotations path, vocab path)."""
        import os

        from PIL import Image

        vocab_path, ann = os.path.join(root, "vocab.json"), os.path.join(root, "ann.json")
        dataset.vocab.to_json(vocab_path)
        os.makedirs(os.path.join(root, "v", "img"))
        items = []
        for r in dataset.records("test"):
            name = f"i{r['img_id']}.jpg"
            img = load_images([r["img_path"]], size)[0]
            Image.fromarray(img).save(os.path.join(root, "v", "img", name), quality=95)
            items.append({"cocoid": r["img_id"], "filepath": "v", "filename": name,
                          "split": "test", "sentences": [{"raw": c} for c in r["captions"]]})
        with open(ann, "w") as f:
            json.dump({"images": items}, f)
        return ann, vocab_path

    def parallel_eval_path(self):
        """Phase 4, run "parallel_eval": `cli/evaluate.py --distributed` as a
        user runs it, in two worker processes on the one card, each joining a
        gloo group itself (NCCL refuses two ranks on one device) before it
        calls the CLI's `main` (`eval_worker`). Seeded Swin-L/384 + d512
        weights at Swin depths SHALLOW (full width), saved as a `.pth`; run
        "eval"'s 12 images as JPEGs (global batches of 8, the last padded);
        beam 3 / L20, the "pallas" backbone and step. Forms (PARALLEL_FORMS):
        "dp" (--n_model 1: two data ranks) and "tp" (--n_model 2: one model
        group of two, every FF, Swin qkv / proj / MLP, the vocabulary
        projection and embedding cut over it) at fp32 with TF32 off, their
        predictions equal token for token to one process's `evaluate_split`
        on the same weights, the first step's log-probs of 8 images within
        PARALLEL_LOGPROB_TOL of one process's; "tp_bf16" held at the metric
        level (PARALLEL_BF16_SCORE_TOL). Each worker's launches counted
        (`eval_worker`): K1 once a block an encoded batch, K2 once a layer
        and step, no kernel off the run's paths. Each form's CLI passes over
        the split PARALLEL_PASSES times (the first loads the kernels in the
        fresh process); prints the last pass's img/s of the decode loop (the
        CLI's own line, scoring apart) beside one process's, and what rank 0
        says a rank holds."""
        import shutil
        import tempfile

        root = tempfile.mkdtemp(prefix="parallel_eval_")
        try:
            self._parallel_eval(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def _parallel_eval(self, root):
        import contextlib
        import dataclasses
        import io
        import os
        import pickle
        import socket

        torch = self.torch
        from on_device_image_captioning_torch.cli import evaluate as eval_cli
        from on_device_image_captioning_torch.data.datasets import load_coco_karpathy
        from on_device_image_captioning_torch.models.end_to_end import (
            EndExpansionNetV2, init_weights,
        )
        from on_device_image_captioning_torch.utils.image import preprocess_batch

        cfg = parallel_eval_cfg(torch)
        model = init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(SEED + 40))
        sd = model.state_dict()
        dataset, load_images = self.eval_split(cfg.captioner)
        ann, vocab_path = self.write_split(root, dataset, load_images, cfg.swin.img_size)
        files = load_coco_karpathy(ann, root, vocab=dataset.vocab)
        records = files.records("test")
        pth = os.path.join(root, "e2e.pth")
        torch.save(sd, pth)
        with open(os.path.join(root, "cfg.pickle"), "wb") as f:  # the workers' config
            pickle.dump(cfg, f)
        first = preprocess_batch([r["img_path"] for r in records[:B_SERVE]], cfg.swin.img_size)
        np.save(os.path.join(root, "first.npy"), first)

        def nonzero(counts):
            return {k: v for k, v in counts.items() if v}

        def rate(text):  # the decode loop's img/s, the CLI's own last line of it
            return float(re.findall(r"\(([0-9.]+) img/s\)", text)[-1])

        one = {}  # bf16 -> (scores, predictions, img/s, first step's log-probs)
        for bf16 in (False, True):
            c = dataclasses.replace(cfg, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
            m = EndExpansionNetV2(c)
            m.load_state_dict(sd)
            m.to(self.dev).eval().prepare_inference()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                for _ in range(PARALLEL_PASSES):
                    scores, preds = eval_cli.evaluate_split(
                        m, c, files, "test", BEAM_SERVE, B_SERVE, L_SERVE,
                        metrics=PARALLEL_METRICS, step_impl="pallas")
            one[bf16] = (scores, {str(k): v for k, v in preds.items()}, rate(out.getvalue()),
                         first_step_log_probs(torch, m, c, first))
            del m
        del model
        torch.cuda.empty_cache()

        cap, swin = cfg.captioner, cfg.swin
        argv = ["--annotations", ann, "--images_path", root, "--vocab_path", vocab_path,
                "--load_path", pth, "--split", "test",
                "--beam_sizes", *[str(BEAM_SERVE)] * PARALLEL_PASSES,
                "--batch_size", str(B_SERVE), "--max_seq_len", str(cap.max_seq_len),
                "--model_dim", str(cap.d_model), "--N_enc", str(cap.N_enc),
                "--N_dec", str(cap.N_dec), "--ff", str(cap.ff), "--num_heads", str(cap.num_heads),
                "--num_exp_enc_list", *map(str, cap.num_exp_enc_list),
                "--num_exp_dec", str(cap.num_exp_dec), "--swin_img_size", str(swin.img_size),
                "--swin_patch_size", str(swin.patch_size), "--swin_embed_dim", str(swin.embed_dim),
                "--swin_depths", *map(str, swin.depths), "--swin_num_heads",
                *map(str, swin.num_heads), "--swin_window_size", str(swin.window_size),
                "--swin_attention_impl", swin.attention_impl, "--step_impl", "pallas",
                "--metrics", *PARALLEL_METRICS, "--distributed", "--device", self.dev.type]
        here = os.path.dirname(os.path.abspath(__file__))
        for form, (n_model, bf16) in PARALLEL_FORMS.items():
            s = socket.socket()
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
            s.close()
            dump = os.path.join(root, f"{form}.json")
            cmd = [sys.executable, "-c", "import sys, chip_smoke; "
                   "sys.exit(chip_smoke.eval_worker(sys.argv[1:]))",
                   os.path.join(root, form), str(n_model), *argv, "--n_model", str(n_model),
                   "--dump_predictions", dump, *(["--bf16"] if bf16 else [])]
            procs = [subprocess.Popen(
                cmd, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
                     "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
                for r in (0, 1)]
            start = time.perf_counter()
            try:
                outs = [p.communicate(timeout=PARALLEL_TIMEOUT)[0] for p in procs]
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                    p.communicate()
                raise AssertionError(f"run {PARALLEL_EVAL!r} form {form!r}: a worker did not "
                                     f"finish within {PARALLEL_TIMEOUT} s")
            wall = time.perf_counter() - start
            for r, (p, out) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    log(out[-4000:])
                    raise AssertionError(f"run {PARALLEL_EVAL!r} form {form!r}: worker {r} "
                                         f"exited {p.returncode}")
            ranks = [torch.load(os.path.join(root, f"{form}.{r}.pt")) for r in (0, 1)]
            with open(dump) as f:
                got = json.load(f)[str(BEAM_SERVE)]
            scores = {m: float(v) for m, v in re.findall(
                r"^(Bleu_\d|CIDEr): ([0-9.]+)$", outs[0], re.M)}
            want_scores, want, one_rate, want_lp = one[bf16]
            # launches: K1 once a block of each batch a rank encodes, K2 once
            # a decoder layer and step (random weights emit no EOS)
            n_data, n = 2 // n_model, len(records)
            for r, rank in enumerate(ranks):
                first = (r if n_model == 1 else 0) * (B_SERVE // n_data)  # of each batch
                batches = sum(s + first < min(s + B_SERVE, n) for s in range(0, n, B_SERVE))
                counts = rank["launches"]
                expect = {"window_attention": sum(swin.depths) * batches * PARALLEL_PASSES,
                          "dyn_exp_step": cap.N_dec * (L_SERVE - 1) * batches * PARALLEL_PASSES}
                bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
                if bad:
                    raise AssertionError(f"run {PARALLEL_EVAL!r} form {form!r} rank {r}: "
                                         f"launches (got, want) {bad}")
                self.check_paths(PARALLEL_EVAL, counts)
            if form == "tp":
                self.launches[PARALLEL_EVAL] = ranks[0]["launches"]
            elif form == "dp":
                self.launches[PARALLEL_DP] = ranks[0]["launches"]
            same = sum(got[k] == want[k] for k in want)
            if set(got) != set(want):
                raise AssertionError(f"run {PARALLEL_EVAL!r} form {form!r}: images "
                                     f"{sorted(got)} against {sorted(want)}")
            lp_err = max(float((rank["log_probs"] - want_lp).abs().max()) for rank in ranks)
            if not bf16:
                if got != want:
                    raise AssertionError(
                        f"run {PARALLEL_EVAL!r} form {form!r}: predictions differ from one "
                        f"process's: {[(k, got[k], want[k]) for k in want if got[k] != want[k]]}")
                if not lp_err <= PARALLEL_LOGPROB_TOL:
                    raise AssertionError(f"run {PARALLEL_EVAL!r} form {form!r}: first-step "
                                         f"log-probs {lp_err:.3e} from one process's")
            worst = max(abs(scores[k] - v) for k, v in want_scores.items())
            if set(scores) != set(want_scores) or not worst <= PARALLEL_BF16_SCORE_TOL:
                raise AssertionError(f"run {PARALLEL_EVAL!r} form {form!r}: scores {scores} "
                                     f"against one process's {want_scores}")
            log(f"phase 4 parallel evaluation, run {PARALLEL_EVAL!r} form {form!r} "
                f"(--n_model {n_model}, {'bf16' if bf16 else 'fp32'}, 2 processes on one card, "
                f"gloo): {same} of {len(want)} captions equal one process's; scores "
                f"{scores} (largest difference {worst:.4f}); first-step log-probs within "
                f"{lp_err:.3e}; launches rank 0 {nonzero(ranks[0]['launches'])}, rank 1 "
                f"{nonzero(ranks[1]['launches'])}; workers' wall {wall:.1f} s")
            held = [line.strip() for line in outs[0].splitlines() if "a rank holds" in line]
            if n_model > 1 and not held:
                raise AssertionError(f"run {PARALLEL_EVAL!r} form {form!r}: rank 0 did not say "
                                     "what the model axis cut")
            log(f"  {held[0] if held else 'weights whole on every rank'}")
            log(f"  decode img/s b{B_SERVE}/beam {BEAM_SERVE}/L{L_SERVE} "
                f"{'bf16' if bf16 else 'fp32'} Swin depths {SHALLOW}: two processes "
                f"({form}) {rate(outs[0]):.2f} against one process {one_rate:.2f} | {self.card}")

    def opcheck_ops(self):
        """Phase 3: `torch.library.opcheck` of every `odic` op on CUDA inputs
        (`ops/_cases.py::opcheck_calls`: the first case of each inference
        kernel, B13's products alone, the shared product), each op once."""
        torch = self.torch
        from on_device_image_captioning_torch.ops import _build, _cases

        checked = {}
        for label, fn in _cases.opcheck_calls(self.dev):
            for op, args, kwargs in _cases.op_calls(fn):
                name = op.__name__.split(".")[0]
                if name in checked:
                    continue
                results = torch.library.opcheck(op, args, kwargs)
                if set(results.values()) != {"SUCCESS"}:
                    raise AssertionError(f"opcheck of odic::{name} ({label}): {results}")
                checked[name] = label
        torch.cuda.synchronize()
        if set(checked) != set(_build.OPS):
            raise AssertionError(f"opcheck reached {sorted(checked)}, not every op of "
                                 f"{sorted(_build.OPS)}")
        log(f"phase 3 torch.library.opcheck on CUDA tensors: all {len(checked)} odic ops pass "
            f"(schema, autograd registration, fake tensors, AOT dispatch): "
            + "; ".join(f"{k} at {v}" for k, v in checked.items()))

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
                self.eval_check(cpu_model, gpu_model, gpu_cfg, imgs)
            else:
                del gpu, gpu_model
                torch.cuda.empty_cache()
        self.compare_tokens("card step_impl 'pallas_fused' vs card 'pallas' (fused backbone)",
                            gpu_caps["fused"], gpu_caps["fused_halves"], beam_margin)
        self.bf16_features(imgs)

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
        calls it): returns fn's result and the pattern `x > 0` of every call
        made while gradients are recorded, in order, on the CPU. With
        `impose`, such a list, each of those calls passes its input where the
        pattern says so and 0 elsewhere, whatever the input's own sign, and
        its gradient follows the pattern too. Calls under no_grad (the SCST
        sampler's plain decode step on the CPU, which the card's K2 makes
        without them) pass through."""
        torch = self.torch
        real, seen, given = torch.relu, [], iter(impose or ())

        def relu(x):
            if not torch.is_grad_enabled():
                return real(x)
            seen.append((x > 0).cpu())
            if impose is None:
                return real(x)
            return torch.where(next(given).to(x.device), x, torch.zeros_like(x))

        torch.relu = relu
        try:
            return fn(), seen
        finally:
            torch.relu = real

    @staticmethod
    def grads(model):
        return {name: p.grad for name, p in model.named_parameters()}

    def grad_shares(self, grads, want, top, tols):
        """Per parameter group ('swin_transf.', 'caption head') the worst of
        `grads` against `want` (the CPU's; both by parameter name) as a share
        of its tolerance: tol x its tensor's max + 0.1 tol x `top`, the
        largest gradient of the model. Returns {group: (share, name)}."""
        worst = {group: (0.0, "") for group in tols}
        for name, g in grads.items():
            group = "swin_transf." if name.startswith("swin_transf.") else "caption head"
            w, tol = want[name], tols[group]
            err = float((g.cpu() - w).abs().max())
            share = err / (tol * float(w.abs().max()) + 0.1 * tol * top)
            if not share <= worst[group][0]:  # also catches NaN
                worst[group] = (share, name)
        return worst

    @staticmethod
    def show_shares(tols, worst):
        return "; ".join(f"{g} (tol {tols[g]:g}) {v:.3f} at {n}" for g, (v, n) in worst.items())

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
        want = self.grads(cpu_model)
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
            return float(loss.detach()), signs, self.grad_shares(self.grads(gpu_model), want, top,
                                                                 tols)

        def held(loss, worst):
            return abs(loss - loss_c) <= 2e-4 * abs(loss_c) and all(
                v <= 1.0 for v, _ in worst.values())

        show = self.show_shares

        # fp32 on both sides through 8 blocks and 6 caption layers, forward and
        # backward: the sums run in another order (chunks, then the chunks'
        # partials in order, on the card). Each
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
        free_tols, same_tols = GRAD_FREE_TOLS, GRAD_SAME_TOLS
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

    # -- SCST -------------------------------------------------------------------
    def synthetic_vocab(self, cap):
        """A synthetic vocabulary of the captioner's V words ("w<i>"), its
        special tokens at their ids. No dataset is read."""
        from on_device_image_captioning_torch.data.text import Vocab

        words = [f"w{i}" for i in range(cap.vocab_size)]
        for token, idx in (("PAD", cap.pad_idx), ("SOS", cap.sos_idx), ("EOS", cap.eos_idx),
                           ("UNK", cap.unk_idx)):
            words[idx] = token
        return Vocab({w: i for i, w in enumerate(words)})

    def scst_corpus(self, cap):
        """(vocab, references, DeviceCiderCorpus) of the SCST runs: a seeded
        synthetic vocabulary of the captioner's V words (its special tokens at
        their ids) and SCST_REFS random references of 8 to 16 words for each
        of SCST_IMAGES images. No dataset is read."""
        from on_device_image_captioning_torch.train.device_cider import DeviceCiderCorpus

        vocab = self.synthetic_vocab(cap)
        plain = [w for w in vocab.idx2word if w.startswith("w")]
        rng = np.random.default_rng(SEED + 11)
        refs = [[" ".join(rng.choice(plain, int(rng.integers(8, 17)))) for _ in range(SCST_REFS)]
                for _ in range(SCST_IMAGES)]
        return vocab, refs, DeviceCiderCorpus(refs, vocab)

    def scst_path(self):
        """Phase 4, SCST: shared-encoder SCST steps at full width and depth on
        the card, the reward on the card; each step's launches, rewards and
        gradients checked."""
        torch = self.torch
        from on_device_image_captioning_torch.train.radam import PlainRAdam
        from on_device_image_captioning_torch.train.scst import CiderReward
        from on_device_image_captioning_torch.train.train_step import make_scst_fused_step

        cfg, model = self.train_model(torch.bfloat16, self.dev)
        cap = cfg.captioner
        vocab, refs, corpus = self.scst_corpus(cap)
        host = CiderReward(refs, use_native="always")  # a failed g++ build raises
        reward_fn = corpus.make_reward_fn(self.dev)
        optimizer = PlainRAdam(model.parameters(), TRAIN_LR)
        step = make_scst_fused_step(model, cfg, optimizer, SCST_SAMPLES, L_SCST, cap.sos_idx,
                                    cap.eos_idx, reward_fn)
        idx = np.arange(B_SCST)
        tables = corpus.batch(idx)
        batch = {"enc_input": torch.from_numpy(self.images(B_SCST, SEED + 11)).to(self.dev)}
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        per_step = []
        for i in range(SCST_STEPS):
            self.counters(reset=True)
            out = step(batch, tables, gen)
            torch.cuda.synchronize()
            counts = self.counters()
            sampled = out["sampled"]
            steps = int(sampled.lengths.max())  # the sampler stops when every row has an EOS
            got = {k: counts[k] for k in TRAIN_LAUNCHES}
            if got != TRAIN_LAUNCHES:  # twice these if the encoder ran twice
                raise AssertionError(f"training launches {got} != {TRAIN_LAUNCHES} in SCST "
                                     f"step {i}")
            if counts["dyn_exp_step"] != N_DEC * steps:
                raise AssertionError(f"K2 launched {counts['dyn_exp_step']} times for {steps} "
                                     f"sampling steps of {N_DEC} layers in SCST step {i}")
            for name, k in KERNELS.items():
                if (counts[name] > 0) != (SCST in k["paths"]):
                    raise AssertionError(
                        f"kernel {name}: {counts[name]} launches in an SCST step, which "
                        f"{'runs' if SCST in k['paths'] else 'does not run'} it")
            rewards = out["rewards"].cpu().numpy()
            want = host(sampled.tokens, sampled.lengths, idx, vocab)
            err = float(np.abs(rewards - want).max())
            if not (np.isfinite(float(out["loss"])) and np.isfinite(rewards).all()):
                raise AssertionError(f"SCST step {i}: loss or rewards not finite")
            if not np.allclose(rewards, want, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"SCST step {i}: on-card CIDEr-D {rewards} departs from the "
                                     f"host's {want}")
            per_step.append(dict(loss=round(float(out["loss"]), 5),
                                 reward=round(float(out["reward"]), 5),
                                 nonzero_rewards=int((rewards > 0).sum()), sampling_steps=steps,
                                 k2=counts["dyn_exp_step"], reward_err=err))
        self.launches[SCST] = counts
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        backbone = max(float(p.grad.abs().max()) for n, p in model.named_parameters()
                       if n.startswith("swin_transf.") and p.grad is not None)
        # random weights score near 0 against random references; the
        # references themselves, every third word swapped for a random one
        # (and the last dropped from every other), give partial matches of
        # every n-gram order
        rng = np.random.default_rng(SEED + 12)
        ref_tokens = np.full((B_SCST, SCST_REFS, L_SCST + 1), cap.pad_idx, np.int32)
        ref_tokens[:, :, 0] = cap.sos_idx
        ref_lengths = np.zeros((B_SCST, SCST_REFS), np.int32)
        for i in idx:
            for j, ref in enumerate(refs[i]):
                ids = [vocab.word2idx[w] for w in ref.split()][:len(ref.split()) - j % 2]
                ids[2::3] = rng.integers(4, cap.vocab_size, len(ids[2::3])).tolist()
                ids = [t if t not in (cap.eos_idx, cap.pad_idx) else t + 100 for t in ids]
                ids.append(cap.eos_idx)
                ref_tokens[i, j, 1:1 + len(ids)] = ids
                ref_lengths[i, j] = len(ids)
        with torch.no_grad():
            self_dev = reward_fn(torch.from_numpy(ref_tokens).to(self.dev),
                                 torch.from_numpy(ref_lengths).to(self.dev), tables).cpu().numpy()
        self_host = host(ref_tokens, ref_lengths, idx, vocab)
        log(f"phase 4 SCST, run {SCST!r}: make_scst_fused_step on Swin-L/384 depths "
            f"{cfg.swin.depths} + d512 captioner, V={cap.vocab_size}, attention_impl='fused', "
            f"bf16 over fp32 masters, b{B_SCST} x {SCST_SAMPLES} samples / L{L_SCST} (fp32 "
            f"sampler caches, step_impl='pallas'), dropout off, PlainRAdam lr {TRAIN_LR}, reward: "
            f"on-card CIDEr-D over {SCST_IMAGES} images x {SCST_REFS} random references; per "
            f"step {per_step}; launches in the last step {counts}; "
            f"{sum(1 for _ in model.parameters())} parameters, {len(bad)} without a finite "
            f"gradient; the backbone's largest gradient in the last step {backbone:.3e}")
        log(f"  on-card CIDEr-D of the references, a third of their words swapped: "
            f"{np.round(self_dev, 4).tolist()}, "
            f"max abs difference from CiderReward (native C++, use_native='always') "
            f"{float(np.abs(self_dev - self_host).max()):.3e} (tol 1e-4 + 1e-4 relative)")
        if bad:
            raise AssertionError(f"parameters without a finite gradient: {bad[:5]}")
        if not (np.allclose(self_dev, self_host, rtol=1e-4, atol=1e-4) and (self_host > 0).all()):
            raise AssertionError("on-card CIDEr-D of the altered references departs from the "
                                 "host's")
        self.scst = (model, step, batch, tables, gen)

    def train_cli_path(self):
        """Phase 4, run "train_cli": `cli/train.py` as a user runs it, on the
        card at full width (Swin-L/384 + d512, V = 10000 by a --vocab_path
        JSON, bf16, "fused", b4), over a corpus in a temporary directory: 8
        seeded 384 x 384 JPEGs written with PIL (6 train, 2 val), 5 random
        references each; no HDF5 file. In order: an XE epoch (7 iterations,
        a checkpoint); a second call with --num_epochs 2 that resumes (its
        first batch the loader's 8th, the optimizer's count restored) with
        --prefetch 2; from that checkpoint (a phase flip) an SCST epoch with
        the on-card reward, then one with the host reward, each with
        --prefetch 2 and the eval hook on val at beam 3; one XE iteration
        with --distributed (NCCL, world size 1) and one with --remat, each
        bit-equal to the same iteration without; the evaluate CLI on the last
        native checkpoint against `api.Captioner` on the same weights. Every
        CLI step's launches are counted: each XE iteration's training
        kernels as run "train"'s (TRAIN_LAUNCHES), and the SCST steps' too
        (the encoder once). Prints s/it at --prefetch 0 and 2 and the peak
        device memory with and without --remat."""
        import shutil
        import tempfile

        root = tempfile.mkdtemp(prefix="train_cli_")
        try:
            self._train_cli(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def _train_cli(self, root):
        import contextlib
        import dataclasses
        import gc
        import os
        import socket

        from PIL import Image

        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.cli import evaluate as eval_cli
        from on_device_image_captioning_torch.cli import train as cli
        from on_device_image_captioning_torch.config import end_expansionnet_v2_coco
        from on_device_image_captioning_torch.data import loader as loader_mod
        from on_device_image_captioning_torch.data.datasets import load_coco_karpathy
        from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
        from on_device_image_captioning_torch.train import train_step
        from on_device_image_captioning_torch.utils import checkpointing as ckpt
        from on_device_image_captioning_torch.utils.image import preprocess_batch

        cfg = end_expansionnet_v2_coco(compute_dtype=torch.bfloat16)
        cfg = dataclasses.replace(
            cfg, swin=dataclasses.replace(cfg.swin, attention_impl="fused"),
            captioner=dataclasses.replace(cfg.captioner, max_seq_len=L_TRAIN))
        vocab = self.synthetic_vocab(cfg.captioner)
        vocab_path, ann = os.path.join(root, "vocab.json"), os.path.join(root, "ann.json")
        vocab.to_json(vocab_path)
        plain = [w for w in vocab.idx2word if w.startswith("w")]
        rng = np.random.default_rng(SEED + 30)
        os.makedirs(os.path.join(root, "v", "img"))
        items = []
        for i, img in enumerate(self.images(CLI_TRAIN + CLI_VAL, SEED + 30)):
            Image.fromarray(img).save(os.path.join(root, "v", "img", f"i{i}.jpg"), quality=95)
            items.append({"cocoid": i, "filepath": "v", "filename": f"i{i}.jpg",
                          "split": "train" if i < CLI_TRAIN else "val",
                          "sentences": [{"raw": " ".join(rng.choice(plain, int(rng.integers(8, 17))))}
                                        for _ in range(CLI_REFS)]})
        with open(ann, "w") as f:
            json.dump({"images": items}, f)
        common = ["--annotations", ann, "--images_path", root, "--vocab_path", vocab_path,
                  "--is_end_to_end", "--bf16", "--swin_attention_impl", "fused",
                  "--batch_size", str(B_TRAIN), "--max_seq_len", str(L_TRAIN), "--seed", str(SEED),
                  "--sched_type", "custom_warmup_anneal", "--warmup_iters", "1",
                  "--lr", str(CLI_LR), "--print_every_iter", "1", "--device", "cuda"]

        # spies: the steps the CLI builds count each call's launches; the
        # loader notes each batch it hands out; the eval hook its scores
        steps = []

        def counted(make, kind):
            def build(*args, **kwargs):
                step = make(*args, **kwargs)

                def run(*a, **k):
                    self.counters(reset=True)
                    out = step(*a, **k)
                    steps.append((kind, self.counters()))
                    return out
                return run
            return build

        batches, evals = [], []
        next_batch = loader_mod.ShardedCaptionLoader.get_next_batch
        evaluate_split = eval_cli.evaluate_split

        def noted(loader, max_seq_len=None):
            batch = next_batch(loader, max_seq_len)
            batches.append(list(batch["img_idxs"]))
            return batch

        def scored(*args, **kwargs):
            out = evaluate_split(*args, **kwargs)
            evals.append(out)
            return out

        def run(save, *extra):
            """cli.main on the common flags; (seconds, peak device MiB above
            what was allocated before, the jsonl rows)."""
            jsonl = f"{save}.{len(os.listdir(root))}.jsonl"  # a log of its own
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rc = cli.main([*common, "--save_path", save + "/", "--metrics_jsonl", jsonl, *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - before) / 2**20
            if rc != 0:
                raise AssertionError(f"cli.train.main returned {rc}")
            gc.collect()
            rows = [json.loads(line) for line in open(jsonl)] if os.path.exists(jsonl) else []
            return seconds, peak, rows

        patches = [(train_step, "make_xe_step", counted(train_step.make_xe_step, "xe")),
                   (train_step, "make_scst_step", counted(train_step.make_scst_step, "scst")),
                   (train_step, "make_scst_fused_step",
                    counted(train_step.make_scst_fused_step, "scst_fused")),
                   (loader_mod.ShardedCaptionLoader, "get_next_batch", noted),
                   (eval_cli, "evaluate_split", scored)]
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, value in patches:
            setattr(obj, name, value)
        try:
            xe = os.path.join(root, "xe")
            # 1. an XE epoch, a checkpoint at its end
            s_xe, peak_xe, rows_xe = run(xe, "--num_epochs", "1")
            if len(rows_xe) != 7 or len(steps) != 7 or not all(
                    np.isfinite(r["loss"]) for r in rows_xe):
                raise AssertionError(f"XE epoch: {len(steps)} steps, losses {rows_xe}")
            first, info = ckpt.load_most_recent(xe)
            if (info, first["step"], first["opt_state"]["count"]) != ("xe", 7, 7):
                raise AssertionError(f"XE checkpoint: {info}, step {first['step']}, count "
                                     f"{first['opt_state']['count']}")
            del first
            # 2. resume to two epochs, with prefetch
            batches.clear()
            s_resume, _, rows_resume = run(xe, "--num_epochs", "2", "--prefetch", "2")
            dataset = load_coco_karpathy(ann, root, vocab=vocab)
            loader = loader_mod.ShardedCaptionLoader(
                dataset, [SEED + e for e in range(2)], batch_size=B_TRAIN)
            eighth = [next_batch(loader)["img_idxs"] for _ in range(8)][-1]
            resumed, _ = ckpt.load_most_recent(xe)
            if batches[0] != list(eighth) or len(rows_resume) != 7:
                raise AssertionError(f"resume: first batch {batches[0]}, the loader's 8th "
                                     f"{eighth}; {len(rows_resume)} iterations")
            if (resumed["step"], resumed["opt_state"]["count"]) != (14, 14):
                raise AssertionError(f"resume: step {resumed['step']}, optimizer count "
                                     f"{resumed['opt_state']['count']} (14 each if restored)")
            xe_counts = [c for kind, c in steps if kind == "xe"]
            for i, counts in enumerate(xe_counts):
                got = {k: counts[k] for k in TRAIN_LAUNCHES}
                if got != TRAIN_LAUNCHES:
                    raise AssertionError(f"CLI XE iteration {i}: training launches {got} != "
                                         f"{TRAIN_LAUNCHES}")
                self.check_paths(TRAIN_CLI, counts)
            self.launches[TRAIN_CLI] = xe_counts[-1]

            # 3. one XE iteration three ways from the same state: the cursor
            # one batch before the end of epoch 2
            resumed["step"] = 13
            resumed["data_loader_state"]["batch_it"] = 6
            one = {}
            for name in ("plain", "ddp", "remat"):
                ckpt.save_checkpoint(os.path.join(root, name), resumed["params"],
                                     resumed["opt_state"], 13, resumed["data_loader_state"], "xe",
                                     epoch_it=1, batch_it=6, batch_size=B_TRAIN)
            del resumed
            s_plain, peak_plain, rows_plain = run(os.path.join(root, "plain"), "--num_epochs", "2")
            s_remat, peak_remat, rows_remat = run(os.path.join(root, "remat"), "--num_epochs", "2",
                                                  "--remat")
            sock = socket.socket()
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
            sock.close()
            env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                   "MASTER_PORT": str(port)}
            os.environ.update(env)
            try:
                _, _, rows_ddp = run(os.path.join(root, "ddp"), "--num_epochs", "2",
                                     "--distributed")
            finally:
                for k in env:
                    os.environ.pop(k, None)
            for name in ("plain", "ddp", "remat"):
                one[name], _ = ckpt.load_most_recent(os.path.join(root, name))
                if one[name]["step"] != 14:
                    raise AssertionError(f"{name}: step {one[name]['step']}, not one iteration")
            for kind, counts in steps[-3:]:
                if kind != "xe" or {k: counts[k] for k in TRAIN_LAUNCHES} != TRAIN_LAUNCHES:
                    raise AssertionError(f"single iterations: {kind} {counts}")
            compared, rows_one = {}, {"ddp": rows_ddp, "remat": rows_remat}
            for name in ("ddp", "remat"):
                loss = (rows_plain[0]["loss"], rows_one[name][0]["loss"])
                dw = max(float((one[name]["params"][k] - v).abs().max())
                         for k, v in one["plain"]["params"].items())
                diff = max(float((a[m] - b[m]).abs().max())
                           for a, b in zip(one[name]["opt_state"]["optimizer"]["state"].values(),
                                           one["plain"]["opt_state"]["optimizer"]["state"].values())
                           for m in ("exp_avg", "exp_avg_sq"))
                compared[name] = (loss, dw, diff)
                if loss[0] != loss[1] or dw != 0 or diff != 0:
                    raise AssertionError(
                        f"{name} iteration against the plain one (bit-equal expected): loss "
                        f"{loss}, weights max abs difference {dw:.3e}, Adam moments {diff:.3e}")
            del one
            gc.collect()

            # 4. SCST from the XE checkpoint (a phase flip), on-card reward, then
            # the host reward; the eval hook on val at beam 3 in each
            scst = ["--reinforce", "--num_samples", str(N_SAMPLES), "--scst_max_len",
                    str(L_TRAIN), "--prefetch", "2", "--eval_every_iter", "1",
                    "--eval_beam_sizes", "3", "--eval_parallel_batch_size", str(CLI_VAL)]
            n_steps = len(steps)
            _, _, rows_dev = run(xe, *scst, "--device_reward", "--num_epochs", "1")
            _, _, rows_host = run(xe, *scst, "--num_epochs", "2")
            kinds = [kind for kind, _ in steps[n_steps:]]
            if kinds != ["scst_fused", "scst"] or len(evals) != 2:
                raise AssertionError(f"SCST epochs: steps {kinds}, {len(evals)} evaluations")
            for kind, counts in steps[n_steps:]:
                if {k: counts[k] for k in TRAIN_LAUNCHES} != TRAIN_LAUNCHES:
                    raise AssertionError(f"CLI {kind} step: training launches {counts}")
            hook = [scores for scores, _ in evals]
            for scores, preds in evals:
                if len(preds) != CLI_VAL or not all(np.isfinite(v) for v in scores.values()):
                    raise AssertionError(f"eval hook: {scores}, {len(preds)} predictions")
            rewards = [rows_dev[0]["reward"], rows_host[0]["reward"]]
            final, info = ckpt.load_most_recent(xe)
            if (info, final["step"]) != ("rf", 2) or not all(np.isfinite(rewards)):
                raise AssertionError(f"SCST: checkpoint {info} step {final['step']}, rewards "
                                     f"{rewards}")

            # 5. the evaluate CLI on the native checkpoint against Captioner
            path = [os.path.join(xe, f) for f in os.listdir(xe) if ckpt._NAME.match(f)][0]
            dump = os.path.join(root, "preds.json")
            with contextlib.redirect_stdout(open(os.devnull, "w")):
                rc = eval_cli.main(["--annotations", ann, "--images_path", root,
                                    "--vocab_path", vocab_path, "--load_path", path,
                                    "--split", "val", "--beam_sizes", "3", "--batch_size",
                                    str(CLI_VAL), "--max_seq_len", str(L_TRAIN), "--bf16",
                                    "--metrics", "bleu", "cider", "--dump_predictions", dump,
                                    "--device", "cuda"])
            if rc != 0:
                raise AssertionError(f"cli.evaluate.main returned {rc}")
            with open(dump) as f:
                got = json.load(f)["3"]
            model = EndExpansionNetV2(cfg)
            model.load_state_dict(final["params"])
            del final
            val = dataset.records("val")
            caps, _ = Captioner(model, cfg, {"beam_size": 3, "beam_max_seq_len": L_TRAIN})(
                preprocess_batch([r["img_path"] for r in val], cfg.swin.img_size))
            want = {str(r["img_id"]): vocab.description(row[0]).lower()
                    for r, row in zip(val, caps)}
            del model
            if got != want:
                raise AssertionError(f"evaluate CLI {got} != Captioner {want}")
        finally:
            for obj, name, value in saved:
                setattr(obj, name, value)
            gc.collect()
            torch.cuda.empty_cache()

        log(f"phase 4 training CLI, run {TRAIN_CLI!r}: cli.train.main on Swin-L/384 + d512, "
            f"V={cfg.captioner.vocab_size} (--vocab_path), bf16, 'fused', b{B_TRAIN}, "
            f"{CLI_TRAIN} train / {CLI_VAL} val JPEGs of 384^2 x {CLI_REFS} references: XE epoch "
            f"losses {[round(r['loss'], 4) for r in rows_xe]}; resumed at iteration 8 (first "
            f"batch {batches[0]} = the loader's 8th), optimizer count 14 after it, losses "
            f"{[round(r['loss'], 4) for r in rows_resume]}; SCST rewards (on-card, host) "
            f"{[round(r, 5) for r in rewards]}, eval hook scores {hook}; "
            f"launches per XE iteration {self.launches[TRAIN_CLI]}")
        for name, (loss, dw, diff) in compared.items():
            what = ("--distributed (NCCL, world size 1)" if name == "ddp" else "--remat")
            log(f"  one XE iteration with {what} against without: loss {loss[1]} vs {loss[0]}, "
                f"weights max abs difference {dw:.3e}, Adam moments (exp_avg, exp_avg_sq) max "
                f"abs difference {diff:.3e} (both held to 0)")
        log(f"  evaluate CLI on the native checkpoint: captions equal to api.Captioner's on "
            f"the same weights ({len(got)} of {len(want)})")
        log(f"  CLI XE s/it at b{B_TRAIN} (StepTimer, iterations after the first two): "
            f"--prefetch 0 {rows_xe[-1]['sec_per_iter']:.4f} (epoch 1), --prefetch 2 "
            f"{rows_resume[-1]['sec_per_iter']:.4f} (epoch 2, resumed); calls {s_xe:.1f} s and "
            f"{s_resume:.1f} s in all | {self.card}")
        log(f"  CLI XE peak device memory above what was allocated before the call, one "
            f"iteration from a checkpoint: {peak_plain:.0f} MiB, with --remat {peak_remat:.0f} MiB "
            f"(the XE epoch's call: {peak_xe:.0f} MiB; calls {s_plain:.1f} s and {s_remat:.1f} s) "
            f"| {self.card}")

    def scst_check(self):
        """Phase 5, SCST: fp32 loss and gradients of one shared-encoder SCST
        step, the kernel path on the card against the plain path on the CPU,
        depths (2, 2, 2, 2), 2 images, the same Gumbel noise and the same
        rewards on both sides; the ReLU-sign rule of `train_check`."""
        torch = self.torch
        from on_device_image_captioning_torch.train.losses import mean_baseline
        from on_device_image_captioning_torch.train.train_step import make_scst_fused_step

        depths = (2, 2, 2, 2)
        cfg, cpu_model = self.train_model(torch.float32, "cpu", depths, dropout=0.0)
        _, gpu_model = self.train_model(torch.float32, self.dev, depths, dropout=0.0)
        cap = cfg.captioner
        images = torch.from_numpy(self.images(2, SEED + 13))
        noise = self.gumbel(SEED + 13, [(2 * SCST_SAMPLES, cap.vocab_size)] * L_SCST)

        def reward_fn(tokens, lengths, tables):
            """An integer function of the tokens: equal on both sides for equal
            tokens, and spread over the samples (random weights against random
            references score 0 almost everywhere, which leaves no gradient)."""
            t = tokens[:, :, 1:].long()
            return ((t * torch.arange(1, t.shape[-1] + 1, device=t.device)).sum(-1) % 7).float()

        def run(model, dev, impose=None):
            step = make_scst_fused_step(model, cfg, torch.optim.SGD(model.parameters(), lr=0.0),
                                        SCST_SAMPLES, L_SCST, cap.sos_idx, cap.eos_idx, reward_fn)
            out, signs = self.relu_signs(
                lambda: step({"enc_input": images.to(dev)}, None, noise=noise), impose)
            if dev != "cpu":
                torch.cuda.synchronize()
            return out, signs

        out_c, signs_c = run(cpu_model, "cpu")
        want = self.grads(cpu_model)
        top = max(float(g.abs().max()) for g in want.values())
        rewards = out_c["rewards"]
        terms = (rewards - mean_baseline(rewards)) * out_c["sampled"].logprobs.sum(-1)
        scale = float(terms.abs().mean())  # the loss is a mean of terms of either sign
        self.counters(reset=True)
        out_g, signs_g = run(gpu_model, self.dev)
        counts = self.counters()
        free_grads = {n: g.cpu() for n, g in self.grads(gpu_model).items()}
        free = self.grad_shares(free_grads, want, top, GRAD_FREE_TOLS)
        flips = sum(int((a != b).sum()) for a, b in zip(signs_g, signs_c))
        # both ways round: the card under the CPU's ReLU signs, and the CPU
        # under the card's (the free-running card's gradients)
        out_s, _ = run(gpu_model, self.dev, impose=signs_c)
        same = self.grad_shares(self.grads(gpu_model), want, top, GRAD_SAME_TOLS)
        out_x, _ = run(cpu_model, "cpu", impose=signs_g)
        mirror = self.grad_shares(free_grads, self.grads(cpu_model), top, GRAD_FREE_TOLS)
        steps = int(out_c["sampled"].lengths.max())

        def same_tokens(out):
            return torch.equal(out["sampled"].tokens.cpu(), out_c["sampled"].tokens)

        def held(out):
            return (same_tokens(out)
                    and torch.equal(out["rewards"].cpu(), rewards)
                    and abs(float(out["loss"]) - float(out_c["loss"])) <= 2e-4 * scale
                    and abs(float(out["logprob_sum"]) - float(out_c["logprob_sum"]))
                    <= 2e-4 * abs(float(out_c["logprob_sum"])))

        # The gradients are held under the ReLU-sign rule of `train_check`,
        # with its two tolerances: the card under the CPU's ReLU patterns
        # against the CPU within the imposed one (5e-5), and the free-running
        # card within the free one (2e-4 backbone, 1e-3 caption head), but
        # against the CPU under the card's patterns. Against the free CPU, a
        # flipped ReLU (its input within rounding of 0) moves one term of
        # each gradient it feeds outright, as in the XE check; but the SCST
        # gradient is a sum of advantage-weighted terms of both signs (an
        # image's advantages sum to 0), so one term weighs much more against
        # the tensor's max than under XE (an H100 run: 10 flips of 7.2
        # million inputs took the free gradients to 43 times the free
        # tolerance, while the card under the CPU's patterns stayed within
        # 0.37 of 5e-5). So that comparison is printed, and the flips are
        # bounded.
        n_relu = sum(a.numel() for a in signs_c)
        show = self.show_shares
        log(f"phase 5 SCST fp32, depths {depths}, 2 images x {SCST_SAMPLES} samples / "
            f"L{L_SCST}, the same Gumbel noise and rewards, card kernels vs CPU plain path: "
            f"sampled tokens equal: {same_tokens(out_g)} "
            f"({steps} sampling steps); loss {float(out_g['loss']):.6f} vs "
            f"{float(out_c['loss']):.6f} (tol 2e-4 x the mean |term| {scale:.4e}); log-prob "
            f"sum {float(out_g['logprob_sum']):.5f} vs {float(out_c['logprob_sum']):.5f} (tol "
            f"2e-4 relative); gradients of {len(want)} parameters against tol x their "
            f"tensor's max + 0.1 tol x the largest gradient ({top:.3e}), free-running (printed, "
            f"not held: flips), worst share of that: {show(GRAD_FREE_TOLS, free)}; launches "
            f"{({k: counts[k] for k in (*TRAIN_LAUNCHES, 'dyn_exp_step')})}")
        log(f"  {flips} of {n_relu} ReLU inputs in {len(signs_c)} calls have another sign on the "
            f"card than on the CPU (bound 1e-5 of them); with the CPU's signs imposed on the "
            f"card (held): tokens equal {same_tokens(out_s)}, "
            f"loss {float(out_s['loss']):.6f}, worst share: {show(GRAD_SAME_TOLS, same)}; the "
            f"free-running card against the CPU under the card's signs (held): loss "
            f"{float(out_x['loss']):.6f}, worst share: {show(GRAD_FREE_TOLS, mirror)}")
        if (len(signs_g) != len(signs_c) or flips > 1e-5 * n_relu or not held(out_g)
                or not held(out_s) or not held(out_x)
                or not all(v <= 1.0 for v, _ in (*same.values(), *mirror.values()))):
            raise AssertionError("the SCST kernel path and the plain path disagree at fp32")
        if counts["swin_block_train"] != 4 or counts["dyn_exp_step"] != N_DEC * steps:
            raise AssertionError("the fp32 SCST check did not go through the kernels")
        del gpu_model
        torch.cuda.empty_cache()

    def scst_timing(self):
        """Phase 6, SCST: ms per shared-encoder SCST step and its split (CUDA
        events at the step's part boundaries), peak memory."""
        torch = self.torch
        model, step, batch, tables, gen = self.scst
        parts = ("encoder", "sampling", "reward", "rescore", "optimizer")
        resident = torch.cuda.memory_allocated() / 2**20  # every earlier run's tensors too
        torch.cuda.reset_peak_memory_stats()
        splits, walls, steps = [], [], []
        for _ in range(3):
            events = []

            def mark(part):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark("start")
            out = step(batch, tables, gen, mark=mark)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            splits.append([events[i].elapsed_time(events[i + 1]) for i in range(len(parts))])
            steps.append(int(out["sampled"].lengths.max()))
        peak = torch.cuda.max_memory_allocated() / 2**20
        med = {p: statistics.median(s[i] for s in splits) for i, p in enumerate(parts)}
        log(f"  SCST step b{B_SCST} x {SCST_SAMPLES} samples / L{L_SCST} bf16, Swin-L/384 + d512: "
            f"{statistics.median(walls):.2f} ms per step (host clock around the synchronized "
            f"step, median of 3: {[round(w, 2) for w in walls]}); CUDA events, medians of 3: "
            + ", ".join(f"{p} {med[p]:.2f} ms" for p in parts)
            + f" (sum {sum(med.values()):.2f} ms; sampling steps {steps}); peak device memory "
            f"{peak:.0f} MiB, of which {resident:.0f} MiB were allocated before the step | "
            f"{self.card}")

    # -- evaluation ---------------------------------------------------------------
    def eval_split(self, cap, n=N_EVAL, seed=SEED + 20, images=None):
        """(dataset, load_images) of the evaluation runs: a test split of n
        records with EVAL_REFS references of 8 to 16 random words of the
        synthetic vocabulary each, and a `load_images(paths, size)` that hands
        out `images` (seeded uint8 arrays when None) in place of image files."""
        from on_device_image_captioning_torch.data.datasets import CaptionDataset

        vocab = self.synthetic_vocab(cap)
        plain = [w for w in vocab.idx2word if w.startswith("w")]
        rng = np.random.default_rng(seed)
        records = [{"img_id": i, "img_path": f"synthetic/{i}.jpg",
                    "captions": [" ".join(rng.choice(plain, int(rng.integers(8, 17))))
                                 for _ in range(EVAL_REFS)]} for i in range(n)]
        if images is None:
            images = self.images(n, seed)
        images = dict(zip((r["img_path"] for r in records), images))

        def load_images(paths, size):
            out = np.stack([images[p] for p in paths])
            if out.shape[1:3] != (size, size):
                raise AssertionError(f"images of {size} asked for; the synthetic ones are "
                                     f"{out.shape[1]}")
            return out

        return CaptionDataset(splits={"test": records}, vocab=vocab, max_seq_len=L_SERVE), \
            load_images

    def padded(self, rows, batch=B_SERVE):
        """The batches `evaluate_split` forms: `batch` rows each, the last one
        padded by repeating its last row."""
        out = []
        for start in range(0, len(rows), batch):
            chunk = rows[start:start + batch]
            pad = batch - len(chunk)
            out.append(np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)]) if pad else chunk)
        return out

    def check_paths(self, run, counts):
        for name, k in KERNELS.items():
            if (counts[name] > 0) != (run in k["paths"]):
                raise AssertionError(
                    f"kernel {name}: {counts[name]} launches in run {run!r}, which "
                    f"{'runs' if run in k['paths'] else 'does not run'} it")

    def reference_decode(self, captioner, dataset, batches, pads=None):
        """`api.Captioner.beam_search` over the padded batches: (the
        predictions `evaluate_split` must give, the launches of each batch)."""
        torch = self.torch
        records, vocab = dataset.records("test"), dataset.vocab
        want, per_batch = {}, []
        for i, x in enumerate(batches):
            self.counters(reset=True)
            caps, _ = captioner.beam_search(x, None if pads is None else pads[i])
            per_batch.append(self.counters())
            for r, row in zip(records[i * B_SERVE:(i + 1) * B_SERVE], caps):
                want[r["img_id"]] = vocab.description(row[0]).lower()
        torch.cuda.synchronize()
        if any(b != per_batch[0] for b in per_batch):
            raise AssertionError(f"api.Captioner's batches launch differently: {per_batch}")
        return want, per_batch

    def run_eval(self, run, model, cfg, dataset, load_images, step_impl, **kw):
        """`evaluate_split` of every metric, counted: (scores, predictions,
        launches)."""
        torch = self.torch
        from on_device_image_captioning_torch.cli.evaluate import evaluate_split

        self.counters(reset=True)
        scores, preds = evaluate_split(
            model, cfg, dataset, "test", BEAM_SERVE, B_SERVE, L_SERVE, verbose=False,
            metrics=EVAL_METRICS, step_impl=step_impl, load_images=load_images, **kw)
        torch.cuda.synchronize()
        counts = self.counters()
        if set(preds) != {r["img_id"] for r in dataset.records("test")}:
            raise AssertionError(f"run {run!r}: an image without a prediction")
        bad = {k: v for k, v in scores.items() if not np.isfinite(v)}
        if len(scores) != 8 or bad:
            raise AssertionError(f"run {run!r}: scores {scores}")
        return scores, preds, counts

    def eval_path(self):
        """Phase 4, evaluation: `cli/evaluate.py::evaluate_split` end to end
        (runs "eval" and "eval_w8a8"), the feature extractor of
        `cli/generate_features.py` ("features") and the features-in
        evaluation over its store ("eval_features"), on phase 4's seeded
        models. Predictions equal `api.Captioner`'s on the same padded
        batches; launches per batch equal the serve runs' for the same path.
        Phase 6 times the loops (`eval_timing`)."""
        import dataclasses

        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.cli.generate_features import (
            extract_features, generate_features,
        )
        from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
        from on_device_image_captioning_torch.utils.image import normalize_on_device

        args = {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE}
        serve = self.serve["fused"]
        cfg, cap = serve.cfg, serve.cap_cfg
        dataset, load_images = self.eval_split(cap)
        records = dataset.records("test")
        imgs = load_images([r["img_path"] for r in records], cfg.swin.img_size)
        batches = self.padded(imgs)

        # run "eval": the "fused" model of run "fused" on the "pallas" step
        reference = Captioner(serve.model, cfg, args, device=self.dev, step_impl="pallas")
        want, per_batch = self.reference_decode(reference, dataset, batches)
        scores, preds, counts = self.run_eval(EVAL, serve.model, cfg, dataset, load_images,
                                              "pallas")
        self.launches[EVAL] = per_batch[0]
        serve_counts = {**ENCODE_LAUNCHES["fused"], **DECODE_LAUNCHES["pallas"]}
        log(f"phase 4 evaluation, run {EVAL!r}: evaluate_split over a synthetic test split of "
            f"{N_EVAL} images x {EVAL_REFS} references (V={cap.vocab_size}), batches of "
            f"{B_SERVE} (the last padded), beam {BEAM_SERVE} / L{L_SERVE} bf16, "
            f"attention_impl='fused', stage modes {serve.model.swin_transf.stage_modes}, "
            f"step_impl='pallas', metrics {EVAL_METRICS} (native METEOR and SPICE): scores "
            f"{ {k: round(v, 6) for k, v in scores.items()} }; predictions equal to "
            f"api.Captioner.beam_search's on the same padded batches: "
            f"{sum(preds[i] == want[i] for i in want)}/{len(want)}; launches per batch "
            f"{per_batch[0]}")
        if preds != want:
            raise AssertionError("run 'eval': predictions differ from api.Captioner's")
        if counts != {k: len(batches) * v for k, v in per_batch[0].items()}:
            raise AssertionError(f"run 'eval': launches {counts} != {len(batches)} x {per_batch[0]}")
        if {k: per_batch[0][k] for k in serve_counts} != serve_counts:
            raise AssertionError(f"run 'eval': launches per batch {per_batch[0]} against the serve "
                                 f"runs' {serve_counts}")
        self.check_paths(EVAL, per_batch[0])

        # run "eval_w8a8": the w8a8 model of run "w8a8", one batch of 8
        qserve = self.serve["w8a8"]
        one = dataclasses.replace(dataset, splits={"test": records[:B_SERVE]})
        want_q, _ = self.reference_decode(qserve, one, batches[:1])
        scores_q, preds_q, counts_q = self.run_eval(EVAL_A8, qserve.model, qserve.cfg, one,
                                                    load_images, "pallas")
        self.launches[EVAL_A8] = counts_q
        log(f"phase 4 evaluation, run {EVAL_A8!r}: the w8a8 model of run 'w8a8', one batch of "
            f"{B_SERVE}: scores { {k: round(v, 6) for k, v in scores_q.items()} }; predictions "
            f"equal to api.Captioner's: {sum(preds_q[i] == want_q[i] for i in want_q)}/"
            f"{len(want_q)}; launches {counts_q} (the 'w8a8' serve run's: "
            f"{counts_q == self.launches['w8a8']})")
        if preds_q != want_q or counts_q != self.launches["w8a8"]:
            raise AssertionError("run 'eval_w8a8' departs from the 'w8a8' serve run")
        self.check_paths(EVAL_A8, counts_q)

        # run "features": the bf16 "pallas" backbone of run "pallas" into stores
        pserve = self.serve["pallas"]
        backbone = pserve.model.swin_transf
        want_f = []
        with torch.inference_mode():
            for x in batches:
                self.counters(reset=True)
                want_f.append(backbone(normalize_on_device(torch.from_numpy(x).to(self.dev)),
                                       pserve.cfg.compute_dtype).float().cpu().numpy())
                one_batch = self.counters()
        self.counters(reset=True)
        extract_features(backbone, batches[0], torch.bfloat16, np.float32)
        torch.cuda.synchronize()
        per_extract = self.counters()
        if per_extract != one_batch:
            raise AssertionError(f"extract_features launches {per_extract} != the 'pallas' "
                                 f"backbone's {one_batch}")
        want_f = np.concatenate(want_f)[:N_EVAL]
        stores = {}
        for dtype in (np.float32, np.float16):
            store = MemoryStore()
            self.counters(reset=True)
            n = generate_features(backbone, records, store, B_SERVE, torch.bfloat16, dtype,
                                  load_images, verbose=False)
            torch.cuda.synchronize()
            counts_f = self.counters()
            if n != N_EVAL or counts_f != {k: len(batches) * v for k, v in one_batch.items()}:
                raise AssertionError(f"run 'features' ({np.dtype(dtype).name} store): {n} images, "
                                     f"launches {counts_f}, want {len(batches)} x {one_batch}")
            stores[np.dtype(dtype).name] = store
        self.launches[FEATURES] = one_batch
        self.check_paths(FEATURES, one_batch)
        got32 = np.stack([stores["float32"].data[r["img_id"]] for r in records])
        got16 = np.stack([stores["float16"].data[r["img_id"]] for r in records])
        err16 = float(np.abs(got16.astype(np.float32) - want_f).max())
        log(f"phase 4 features, run {FEATURES!r}: generate_features over the {N_EVAL} images, "
            f"the bf16 'pallas' backbone of run 'pallas', batches of {B_SERVE}: float32 store "
            f"{got32.shape} {got32.dtype} equal to the run's encoder features: "
            f"{np.array_equal(got32, want_f)}; float16 store {got16.dtype}, max abs difference "
            f"{err16:.3e} (tol {F16_FEATURES_TOL:g} + {F16_FEATURES_TOL:g} relative); launches "
            f"per batch {one_batch}")
        if not np.array_equal(got32, want_f):
            raise AssertionError("run 'features': the float32 store departs from the encoder's")
        if got16.dtype != np.float16 or not np.allclose(
                got16.astype(np.float32), want_f, rtol=F16_FEATURES_TOL, atol=F16_FEATURES_TOL):
            raise AssertionError("run 'features': the float16 store departs from the encoder's")
        self.feature_store = stores["float32"]

        # run "eval_features": the caption head of the same weights over the store
        head = ExpansionNetV2(pserve.cap_cfg)
        head.load_state_dict({k: v for k, v in pserve.model.state_dict().items()
                              if not k.startswith("swin_transf.")}, strict=True)
        head.to(self.dev).eval()
        feats, pads = stores["float32"].read_batch([r["img_id"] for r in records])
        feats = self.padded(feats)
        pads = [torch.from_numpy(p) for p in self.padded(np.asarray(pads, np.int32))]
        head_ref = Captioner(head, pserve.cap_cfg, args, device=self.dev, step_impl="pallas")
        want_h, per_batch_h = self.reference_decode(head_ref, dataset, feats, pads)
        scores_h, preds_h, counts_h = self.run_eval(
            EVAL_FEATURES, head, pserve.cap_cfg, dataset, load_images, "pallas",
            features_path="in memory", feature_store=stores["float32"])
        self.launches[EVAL_FEATURES] = per_batch_h[0]
        log(f"phase 4 evaluation, run {EVAL_FEATURES!r}: evaluate_split features in over the "
            f"float32 store, the caption head of run 'pallas''s weights, fp32 caches, "
            f"step_impl='pallas': scores { {k: round(v, 6) for k, v in scores_h.items()} }; "
            f"predictions equal to api.Captioner's: "
            f"{sum(preds_h[i] == want_h[i] for i in want_h)}/{len(want_h)}; launches per batch "
            f"{per_batch_h[0]}")
        if preds_h != want_h or counts_h != {k: len(feats) * v for k, v in per_batch_h[0].items()}:
            raise AssertionError("run 'eval_features' departs from api.Captioner's decode")
        if per_batch_h[0]["dyn_exp_step"] != N_DEC * (L_SERVE - 1):
            raise AssertionError(f"run 'eval_features': K2 {per_batch_h[0]['dyn_exp_step']} times "
                                 f"a batch, want {N_DEC * (L_SERVE - 1)}")
        self.check_paths(EVAL_FEATURES, per_batch_h[0])
        self.evals = dict(dataset=dataset, load_images=load_images, batches=batches,
                          reference=reference, head=head, head_ref=head_ref, feats=feats,
                          pads=pads)

    def eval_check(self, cpu_model, gpu_model, cfg, imgs):
        """Phase 5, evaluation at fp32 on the card against the plain path on the
        CPU: 2 images through the features-in evaluation (the caption head of
        `cpu_model`'s weights, the first two images' features of phase 4's
        float32 store) with tokens equal and beam log-probs within the decode
        tolerance; then `compute_evaluation_loss` end to end on the phase's 2
        images within 1e-4 relative."""
        torch = self.torch
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.cli.evaluate import (
            compute_evaluation_loss, evaluate_split,
        )
        from on_device_image_captioning_torch.decode import beam_search as bs
        from on_device_image_captioning_torch.models.captioner import ExpansionNetV2

        cap = cfg.captioner
        dataset, _ = self.eval_split(cap, n=2, seed=SEED + 21)
        records = dataset.records("test")
        store = MemoryStore()
        for r, i in zip(records, (0, 1)):
            store.data[r["img_id"]] = self.feature_store.data[i]
        head_c = ExpansionNetV2(cap)
        head_c.load_state_dict({k: v for k, v in cpu_model.state_dict().items()
                                if not k.startswith("swin_transf.")}, strict=True)
        head_c.eval()
        head_g = ExpansionNetV2(cap)
        head_g.load_state_dict(head_c.state_dict(), strict=True)
        head_g.to(self.dev).eval()
        args = {"beam_size": BEAM_SERVE, "beam_max_seq_len": L_SERVE}
        feats, pads = store.read_batch([r["img_id"] for r in records])
        pads = torch.tensor(pads, dtype=torch.int32)
        out = {}
        for name, head, dev in (("cpu", head_c, "cpu"), ("card", head_g, self.dev)):
            c = Captioner(head, cap, args, device=dev, step_impl="pallas")
            res = c.decode(c.forward_enc(feats, pads), pads)
            _, preds = evaluate_split(head, cap, dataset, "test", BEAM_SERVE, 2, L_SERVE,
                                      features_path="in memory", verbose=False, metrics=("bleu",),
                                      step_impl="pallas", feature_store=store)
            out[name] = (res, preds)
        caps_c, lps_c = bs.captions_from_result(out["cpu"][0])
        caps_g, lps_g = bs.captions_from_result(out["card"][0])
        with torch.inference_mode():
            enc_c = head_c.forward_enc(torch.from_numpy(feats), pads)

        def margin(i, j, t, a, b):
            with torch.inference_mode():
                prefix = torch.tensor([b[:t]], dtype=torch.int64)
                lp = head_c.forward_dec(enc_c[i:i + 1], prefix, None, pads[i:i + 1],
                                        apply_log_softmax=True)
            return abs(float(lp[0, t - 1, a[t]] - lp[0, t - 1, b[t]]))

        lp_err = max((float(np.abs(np.asarray(a) - np.asarray(b)).max())
                      for ra, rb, ca, cb in zip(lps_g, lps_c, caps_g, caps_c)
                      for a, b, x, y in zip(ra, rb, ca, cb) if x == y), default=0.0)
        log(f"phase 5 features-in evaluation fp32, 2 images, card kernels vs CPU plain path, same "
            f"features: predictions equal {out['card'][1] == out['cpu'][1]}; beam log-probs "
            f"max_abs {lp_err:.3e} where the tokens agree (tol atol 1e-4)")
        self.compare_tokens("features-in evaluation, card vs CPU", caps_g, caps_c, margin)
        if caps_g == caps_c and out["card"][1] != out["cpu"][1]:
            raise AssertionError("features-in evaluation: equal tokens, other predictions")
        if not lp_err <= 1e-4:
            raise AssertionError("features-in evaluation: beam log-probs outside tolerance")

        # the eval loss end to end at fp32
        e2e, load_images = self.eval_split(cap, n=2, seed=SEED + 22, images=imgs)
        loss_c = compute_evaluation_loss(cpu_model, cfg, e2e, "test", 2, load_images=load_images)
        loss_g = compute_evaluation_loss(gpu_model, cfg, e2e, "test", 2, load_images=load_images)
        rel = abs(loss_g - loss_c) / abs(loss_c)
        log(f"phase 5 compute_evaluation_loss end to end fp32, 2 images (first references of "
            f"{min(len(r['captions'][0].split()) for r in e2e.records('test'))} words and more): "
            f"card {loss_g:.7f} vs CPU {loss_c:.7f}, relative difference {rel:.3e} (tol 1e-4)")
        if not (np.isfinite(loss_c) and rel <= 1e-4):
            raise AssertionError("compute_evaluation_loss: the card departs from the CPU")
        del head_g
        torch.cuda.empty_cache()

    def bf16_features(self, imgs):
        """The bf16 backbone at full depth: the features (2, 144, 1536) of the
        "fused" runs (D: default stage modes; H: every stage on the halves)
        against the "pallas" run's, same weights and images. The "pallas"
        backbone runs none of the shared product's kernels and phase 5's fp32
        checks run the product's fp32 route, so this is where its bf16 route
        meets the whole depth."""
        torch = self.torch
        from on_device_image_captioning_torch.utils.image import normalize_on_device

        x = normalize_on_device(torch.from_numpy(imgs).to(self.dev))
        feats = {}
        with torch.inference_mode():
            for run in RUNS:
                cap = self.serve[run]
                feats[run] = cap.model.swin_transf(x, cap.cfg.compute_dtype).float()
        want = feats["pallas"]
        for run, form in (("fused", "D"), ("fused_halves", "H")):
            diff = feats[run] - want
            rel = float(diff.square().mean().sqrt() / want.square().mean().sqrt())
            log(f"phase 5 bf16 backbone features {tuple(want.shape)}, form {form} (run {run!r}) "
                f"vs 'pallas': relative RMS {rel:.4e}, max abs {float(diff.abs().max()):.4e} "
                f"(bound {BF16_FEATURES_REL_RMS:g})")
            if not rel <= BF16_FEATURES_REL_RMS:
                raise AssertionError(f"run {run!r}: bf16 backbone features depart from 'pallas'")

    # -- phase 6 ---------------------------------------------------------------
    def product_timing(self):
        """The shared bf16 product alone at the four stage-2 products of a b8
        encode (M = 4608 rows), as B4 and B5 launch it, beside `F.linear` on
        the same tensors (a yardstick only: the port never calls it)."""
        torch = self.torch
        F = torch.nn.functional
        from on_device_image_captioning_torch.ops import fused_linear as fl
        from on_device_image_captioning_torch.ops import linear_plan as lp

        g = torch.Generator().manual_seed(SEED + 9)
        rn = lambda shape, scale=1.0, dt=torch.float32: (  # noqa: E731
            torch.randn(shape, generator=g) * scale).to(self.dev, dt)
        bf, m, c = torch.bfloat16, 4608, 768
        x, h = rn((m, c), dt=bf), rn((m, 4 * c), dt=bf)
        log(f"phase 6 the shared product alone at b8 stage 2 (M {m}), device ms by CUDA-graph "
            f"replay, beside F.linear on the same tensors ({self.card})")
        for name, a, n, norm, gelu, resid in (
                ("qkv, LayerNorm prologue", x, 3 * c, True, False, False),
                ("proj, residual", x, c, False, False, True),
                ("fc1, LayerNorm prologue and GELU", x, 4 * c, True, True, False),
                ("fc2, residual", h, c, False, False, True)):
            k = a.shape[1]
            w, b = rn((k, n), k ** -0.5, bf), rn((n,))
            ln = (rn((k,), 0.2) + 1, rn((k,), 0.2)) if norm else None
            r = x if resid else None
            ms = self.graph_time(lambda: fl.fused_linear(a, w, b, ln, gelu=gelu, resid=r))
            w_t = w.t().contiguous()
            lib = self.graph_time(lambda: F.linear(a, w_t))
            sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
            plan = lp.linear_plan(m, n, k, 1, 2, sms)
            tflops = 2 * m * n * k / 1e9
            log(f"  {name} ({m}, {k}) -> {n}: {fmt(ms)} ({tflops / ms:.0f} TFLOP/s; tile "
                f"{plan.tile}, {plan.ctas} CTAs), F.linear {fmt(lib)} ({tflops / lib:.0f} TFLOP/s) "
                f"| {self.card}")

    def a8_product_timing(self):
        """B13's two int8 products alone at the main path's w8a8 shapes
        (ops/_cases.py MAIN_PATH_A8): fc1 with its epilogue (the fp32 GELU
        output and its row absmaxes) and fc2 with the residual (bf16), each
        in the form the plan picks, beside `torch._int_mm` on the same int8
        operands (a yardstick only: the port never calls it; it returns the
        int32 sums and nothing else); device ms by CUDA-graph replay."""
        torch = self.torch
        from on_device_image_captioning_torch.ops import _cases
        from on_device_image_captioning_torch.ops import linear_plan as lp
        from on_device_image_captioning_torch.ops import swin_block_fused as sbf

        g = torch.Generator().manual_seed(SEED + 11)
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        log(f"phase 6 B13's int8 products alone, device ms by CUDA-graph replay, beside "
            f"torch._int_mm on the same int8 operands ({self.card})")
        for b, stage in _cases.MAIN_PATH_A8:
            c, _, res = _cases.STAGES[stage]
            m = b * res * res
            for name, k, n, fc2 in (("fc1", c, 4 * c, False), ("fc2", 4 * c, c, True)):
                a_q = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(self.dev)
                w_q = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(self.dev)
                s = ((torch.rand((n,), generator=g) + 0.5) * (k ** -0.5 / 73.0)).to(self.dev)
                bias = (torch.randn((n,), generator=g) * 0.2).to(self.dev)
                if fc2:  # a_scale: the hidden rows' absmaxes
                    a_scale = (torch.rand((m,), generator=g) + 1.0).to(self.dev)
                    resid = torch.randn((m, n), generator=g).to(self.dev, torch.bfloat16)
                else:
                    a_scale = ((torch.rand((m,), generator=g) + 0.5) / 127.0).to(self.dev)
                    resid = None
                ms = self.graph_time(
                    lambda: sbf.mlp_a8_product(a_q, a_scale, (w_q, s, bias), resid))
                w_t = w_q.t()
                lib = self.graph_time(lambda: torch._int_mm(a_q, w_t))
                plan = lp.int8_plan(m, n, k, sms)
                tops = 2 * m * n * k / 1e9
                log(f"  b{b} stage{stage} {name} ({m}, {k}) -> {n}: {fmt(ms)} "
                    f"({tops / ms:.0f} TOP/s; tile {plan.tile}, {plan.ctas} CTAs), "
                    f"torch._int_mm {fmt(lib)} ({tops / lib:.0f} TOP/s), ratio "
                    f"{ms / lib:.2f} | {self.card}")

    def merge_product_timing(self):
        """B8 in bf16 at B = 2 and at the main path's shapes (ops/_cases.py
        MAIN_PATH_MERGES): the plan's tile and split, the whole call (the
        row-statistics pre-pass and the product), the product alone on the
        statistics a first call left, and `F.linear` on the same normalized
        bf16 rows (a yardstick only: the port never calls it); device ms by
        CUDA-graph replay."""
        torch = self.torch
        F = torch.nn.functional
        from on_device_image_captioning_torch.ops import _cases
        from on_device_image_captioning_torch.ops import layernorm as k4
        from on_device_image_captioning_torch.ops import stage_boundary as sb

        log(f"phase 6 B8's product alone beside F.linear on the same normalized rows, device "
            f"ms by CUDA-graph replay ({self.card})")
        for case in _cases.CASES["downsample"](self.dev):
            if "bfloat16" not in case.label:
                continue
            xw, norm, w, w_in, window, eps = case.args
            plan = sb.downsample_plan(xw)
            rows = k4.layernorm_reference(sb._merged_rows(xw, w_in, window), *norm, eps)
            rows = rows.reshape(-1, w.shape[0])
            w_t = w.t().contiguous()
            whole = self.graph_time(case.run_kernel)
            alone = self.graph_time(case.time_alone)
            lib = self.graph_time(lambda: F.linear(rows, w_t))
            tf = 2 * rows.shape[0] * w.shape[0] * w.shape[1] / 1e9
            route = f"{plan.splits} splits" if plan.ring else "the scratch route"
            log(f"  downsample {case.label}: tile {plan.tile}, {route} "
                f"({plan.ctas} CTAs): whole {fmt(whole)}, product alone {fmt(alone)} "
                f"({tf / alone:.0f} TFLOP/s), F.linear {fmt(lib)} ({tf / lib:.0f} TFLOP/s) "
                f"| {self.card}")

    def grad_product_timing(self):
        """The training backwards' product alone at the XE step's b4 shapes of
        stages 0-2 (B9c's five products and B9b's four, each in the launch
        plan's tile form and split, partials summed, each output in the type
        the path keeps: dxn fp32, the weight gradients fp32, the rest bf16;
        B9c runs fc1 and dh1 as one fused launch, timed here as two), beside
        `torch.matmul` on the same bf16 operands (a yardstick only: the port
        never calls it; its outputs are bf16); device ms by CUDA-graph replay."""
        torch = self.torch
        from on_device_image_captioning_torch.ops import fused_linear as fl
        from on_device_image_captioning_torch.ops import linear_plan as lp

        g = torch.Generator().manual_seed(SEED + 10)
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        log(f"phase 6 the backward product alone at the XE step's b{B_TRAIN} shapes, device ms "
            f"by CUDA-graph replay, beside torch.matmul on the same operands ({self.card})")
        self.grad_tflops = {}
        for stage, (c, res) in enumerate(((192, 96), (384, 48), (768, 24))):
            r = B_TRAIN * res * res
            flops = ms_sum = lib_sum = 0.0
            for name, m, n, k, layout, rounded in (
                    ("fc1 recompute x.W1", r, 4 * c, c, "xw", True),
                    ("dh1 dmlp.W2^T", r, 4 * c, c, "dywt", True),
                    ("dxn2 dh1.W1^T", r, c, 4 * c, "dywt", False),
                    ("dW1 xn2^T.dh1", c, 4 * c, r, "atb", False),
                    ("dW2 g^T.dmlp", 4 * c, c, r, "atb", False),
                    ("dao dproj.Wproj^T", r, c, c, "dywt", True),
                    ("dxn1 dqkv.Wqkv^T", r, c, 3 * c, "dywt", False),
                    ("dWproj attn^T.dproj", c, c, r, "atb", False),
                    ("dWqkv xn1^T.dqkv", c, 3 * c, r, "atb", False)):
                shapes = {"xw": ((m, k), (k, n)), "dywt": ((m, k), (n, k)),
                          "atb": ((k, m), (k, n))}[layout]
                a, b = ((torch.randn(sh, generator=g)).to(self.dev, torch.bfloat16)
                        for sh in shapes)
                ms = self.graph_time(lambda: fl.grad_product(a, b, layout, rounded=rounded))
                x = a.t() if layout == "atb" else a
                y = b.t() if layout == "dywt" else b
                lib = self.graph_time(lambda: torch.matmul(x, y))
                plan = lp.grad_plan(m, n, k, layout, 2, sms)
                tf = 2 * m * n * k / 1e9
                flops, ms_sum, lib_sum = flops + tf, ms_sum + ms, lib_sum + lib
                log(f"  stage{stage} {name} ({m} x {n}, K {k}, {layout}, "
                    f"{'bf16' if rounded else 'fp32'} out): {fmt(ms)} ({tf / ms:.0f} TFLOP/s; "
                    f"tile {plan.tile}, {plan.splits} chunks, {plan.ctas} CTAs), torch.matmul "
                    f"{fmt(lib)} ({tf / lib:.0f} TFLOP/s) | {self.card}")
            self.grad_tflops[stage] = flops / ms_sum
            log(f"  stage{stage} all nine: {ms_sum:.4f} ms ({flops / ms_sum:.0f} TFLOP/s), "
                f"torch.matmul {lib_sum:.4f} ms ({flops / lib_sum:.0f} TFLOP/s) | {self.card}")

    def topk_cluster_timing(self):
        """K3 at each of its cases in every cluster size the kernel takes,
        each held exactly to the plain version, device ms by CUDA-graph
        replay; the size `topk_plan` picks is marked."""
        torch = self.torch
        from on_device_image_captioning_torch.ops import _cases
        from on_device_image_captioning_torch.ops import topk as k3

        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        log(f"phase 6 K3 in every cluster size, device ms by CUDA-graph replay ({self.card})")
        for case in _cases.CASES["topk"](self.dev):
            x, k = case.args
            rows, v = x.shape
            pick = k3.topk_plan(rows, v, k, sms, x.element_size()).cluster
            want = k3.topk_reference(x, k)
            times = []
            for cluster in k3.CLUSTER_SIZES:
                plan = k3.TopkPlan(cluster, rows * cluster)
                got = k3.launch(x, k, plan)
                for part, a, b in (("indices", got[1], want[1]), ("values", got[0], want[0])):
                    if not _cases.compare(a, b, _cases.EXACT)[2]:
                        raise AssertionError(f"topk {case.label} cluster {cluster} {part} "
                                             "disagrees with its plain version")
                ms = self.graph_time(lambda: k3.launch(x, k, plan))
                times.append(f"{cluster}{'*' if cluster == pick else ''}: {fmt(ms)}")
            log(f"  topk {case.label}, CTAs a row (* the plan's): {'; '.join(times)} "
                f"| {self.card}")

    def backward_launches(self):
        """CUDA launches (kernels, copies, fills) in one call of B9c and of
        B9b at their table shapes, from one profiled call."""
        from on_device_image_captioning_torch.cli.breakdown import device_profile
        from on_device_image_captioning_torch.ops import _cases

        for name in ("swin_mlp_bwd", "swin_attn_bwd"):
            case = next(c for c in _cases.CASES[name](self.dev)
                        if c.label == KERNELS[name]["headline"])
            case.run_kernel()
            prof = device_profile(case.run_kernel)
            log(f"  {name} {case.label}: {prof['launches']} CUDA launches per call "
                f"({', '.join(f'{t['name'][:48]} x{t['calls']}' for t in prof['top'])}) "
                f"| {self.card}")

    def kernel_timing(self, names=None):
        from on_device_image_captioning_torch.ops import _cases

        log(f"phase 6 times, ms per call: CUDA events around back-to-back calls (host included); "
            f"device: the same calls replayed from a CUDA graph ({self.card})")
        for name in names or _cases.CASES:
            for case in _cases.CASES[name](self.dev):
                ms = self.cuda_time(case.time_kernel or case.run_kernel)
                device_ms = self.graph_time(case.time_kernel or case.run_kernel)
                plain_ms = self.cuda_time(case.time_plain or case.run_plain)
                alone = {}
                if case.time_alone is not None:
                    alone = dict(alone_ms=self.cuda_time(case.time_alone),
                                 alone_device_ms=self.graph_time(case.time_alone))
                library = self.library_call(case)
                library_ms = None if library is None else self.cuda_time(library)
                library_device_ms = None if library is None else self.graph_time(library)
                peak = (INT8_OPS if case.int8 else
                        BF16_FLOPS if case.matmul and "bfloat16" in case.label else FP32_FLOPS)
                by_bytes, by_ops = 1e3 * case.nbytes / HBM_BYTES_S, 1e3 * case.flops / peak
                bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
                if MAIN_PATH_LABEL.match(case.label):  # a main-path shape of its own
                    self.case_times.setdefault(case.kernel, []).append(dict(
                        label=case.label, device_ms=device_ms, ms=ms, bound_ms=bound_ms,
                        bound_by=bound_by))
                if case.label == KERNELS[case.kernel]["headline"]:
                    self.times[case.kernel] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms, device_ms=device_ms,
                        library_device_ms=library_device_ms, **alone)
                lib = "none" if library_ms is None else (
                    f"{library_ms:.4f} ms (device {fmt(library_device_ms)})")
                last = "" if not alone else (
                    f" (its last launch alone {alone['alone_ms']:.4f} ms, "
                    f"device {fmt(alone['alone_device_ms'])})")
                log(f"  {case.kernel} {case.label}: kernel {ms:.4f} ms (device {fmt(device_ms)}){last}, "
                    f"plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.5f} ms by {bound_by} ({case.nbytes} B, {case.flops} flop), "
                    f"library {lib} | {self.card}")
        self.block_against_halves()

    def block_against_halves(self):
        """B6 against the two halves it replaces (B4 + B5) at each main-path
        shape both have cases at, device ms from the same call."""
        def at(kernel, b, stage):
            return next((t["device_ms"] for t in self.case_times.get(kernel, [])
                         if t["label"].startswith(f"b{b} stage{stage} ")), None)

        from on_device_image_captioning_torch.ops import _cases

        for b, stage in _cases.MAIN_PATH_BLOCKS:
            block = at("swin_block", b, stage)
            halves = [at(k, b, stage) for k in ("swin_attn_half", "swin_mlp_half")]
            if block is None or None in halves:
                continue
            log(f"  B6 against B4 + B5 at b{b} stage{stage}, device ms: {block:.4f} against "
                f"{halves[0]:.4f} + {halves[1]:.4f} = {sum(halves):.4f} "
                f"({'faster' if block < sum(halves) else 'slower'}) | {self.card}")

    def eval_timing(self):
        """Phase 6, evaluation: img/s of `evaluate_split`'s loop (prefetch,
        copies and drain included; scored on no metric, the scoring timed
        apart) against `api.Captioner.beam_search` on the same padded
        batches, in turns (C E E C, three times; host clock, medians), end to
        end ("eval") and features in ("eval_features"); img/s of
        `generate_features` into float32 and float16 stores in turns."""
        torch = self.torch
        from on_device_image_captioning_torch.cli.evaluate import evaluate_split
        from on_device_image_captioning_torch.cli.generate_features import generate_features
        from on_device_image_captioning_torch.evalcap.harness import evaluate_captions

        e = self.evals
        dataset, load_images = e["dataset"], e["load_images"]
        records = dataset.records("test")

        def wall(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out

        def in_turns(one, other):
            got = {"C": [], "E": []}
            for side in "CEEC" * 3:
                got[side].append(wall(one if side == "C" else other)[0])
            return got

        serve = self.serve["fused"]
        head = e["head"]
        loops = {
            EVAL: (lambda: [e["reference"].beam_search(x) for x in e["batches"]],
                   lambda: evaluate_split(serve.model, serve.cfg, dataset, "test", BEAM_SERVE,
                                          B_SERVE, L_SERVE, verbose=False, metrics=(),
                                          step_impl="pallas", load_images=load_images)),
            EVAL_FEATURES: (lambda: [e["head_ref"].beam_search(x, p)
                                     for x, p in zip(e["feats"], e["pads"])],
                            lambda: evaluate_split(head, head.cap_cfg, dataset, "test",
                                                   BEAM_SERVE, B_SERVE, L_SERVE,
                                                   features_path="in memory", verbose=False,
                                                   metrics=(), step_impl="pallas",
                                                   feature_store=self.feature_store)),
        }
        log(f"phase 6 evaluation loops, {N_EVAL} images in {len(e['batches'])} padded batches of "
            f"{B_SERVE}, beam {BEAM_SERVE} / L{L_SERVE}, host clock ({self.card})")
        for run, (captioner, loop) in loops.items():
            got = in_turns(captioner, loop)
            c, ev = statistics.median(got["C"]), statistics.median(got["E"])
            log(f"  run {run!r}: evaluate_split {N_EVAL / ev:.3f} img/s (median of "
                f"{len(got['E'])}: {[round(t, 4) for t in got['E']]} s) against "
                f"api.Captioner.beam_search {N_EVAL / c:.3f} img/s "
                f"({[round(t, 4) for t in got['C']]} s), turns C E E C x 3 | {self.card}")
        _, (_, preds) = wall(loops[EVAL][1])
        refs = {r["img_id"]: r["captions"] for r in records}
        score_s = [wall(lambda: evaluate_captions(preds, refs, metrics=EVAL_METRICS))[0]
                   for _ in range(3)]
        log(f"  the scoring of {N_EVAL} images x {EVAL_REFS} references, all five metrics on the "
            f"host: {statistics.median(score_s):.4f} s (median of 3: "
            f"{[round(t, 4) for t in score_s]})")
        backbone = self.serve["pallas"].model.swin_transf
        rates = {"float32": [], "float16": []}
        for name in ("float32", "float16", "float16", "float32") * 2:
            t, n = wall(lambda: generate_features(backbone, records, MemoryStore(), B_SERVE,
                                                  torch.bfloat16, np.dtype(name), load_images,
                                                  verbose=False))
            rates[name].append(n / t)
        for name, r in rates.items():
            log(f"  run {FEATURES!r}, {name} store: {statistics.median(r):.3f} img/s (median of "
                f"{len(r)} in turns: {[round(x, 2) for x in r]}) | {self.card}")

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


def parallel_eval_cfg(torch):
    """Run "parallel_eval"'s configuration: Swin-L/384 + d512 (V = 10000)
    at Swin depths SHALLOW, the "pallas" backbone, max_seq_len L_SERVE, fp32."""
    import dataclasses

    from on_device_image_captioning_torch.config import end_expansionnet_v2_coco

    cfg = end_expansionnet_v2_coco(compute_dtype=torch.float32)
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, attention_impl="pallas", depths=SHALLOW),
        captioner=dataclasses.replace(cfg.captioner, max_seq_len=L_SERVE))


def first_step_log_probs(torch, model, cfg, images):
    """The decoder's first step (SOS at position 0) over uint8 images: (B, V)
    fp32 log-probs on the host."""
    from on_device_image_captioning_torch.decode import cache as dc
    from on_device_image_captioning_torch.utils.image import normalize_on_device

    dev = next(model.parameters()).device
    with torch.inference_mode():
        enc = model.forward_enc(normalize_on_device(torch.from_numpy(images).to(dev)))
        state = dc.init_state(model, cfg.captioner, enc, L_SERVE, cfg.compute_dtype)
        sos = torch.full((enc.shape[0],), cfg.captioner.sos_idx, dtype=torch.int32, device=dev)
        lp, _ = dc.dec_step(model, cfg.captioner, state, sos, 0, cfg.compute_dtype)
    return lp.float().cpu()


def eval_worker(argv) -> int:
    """One rank of run "parallel_eval" (`Smoke.parallel_eval_path` starts two,
    with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set): joins a gloo
    group, calls `cli/evaluate.py::main(argv[2:])` (which keeps the group it
    finds), then the first step's log-probs of <dir>/first.npy on the same
    model (<dir>/cfg.pickle, in the CLI's dtype) cut over `--n_model`
    argv[1]; saves both and the launches of the CLI's call to
    <argv[0]>.<rank>.pt."""
    import dataclasses
    import os
    import pickle

    import torch
    import torch.distributed as dist

    from on_device_image_captioning_torch.cli import evaluate as eval_cli
    from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
    from on_device_image_captioning_torch.parallel import mesh as pm

    out, n_model, cli_args = argv[0], int(argv[1]), argv[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="env://")
    try:
        smoke = Smoke(torch)
        smoke.counters(reset=True)
        rc = eval_cli.main(cli_args)
        cuda = cli_args[cli_args.index("--device") + 1] == "cuda"
        if cuda:
            torch.cuda.synchronize()
        launches = smoke.counters()
        with open(os.path.join(os.path.dirname(out), "cfg.pickle"), "rb") as f:
            cfg = dataclasses.replace(pickle.load(f), compute_dtype=(
                torch.bfloat16 if "--bf16" in cli_args else torch.float32))
        model = EndExpansionNetV2(cfg)
        model.load_state_dict(torch.load(cli_args[cli_args.index("--load_path") + 1]))
        pm.shard_model(model, pm.make_grid(n_model))
        model.to(torch.device("cuda", torch.cuda.current_device()) if cuda else "cpu")
        model.eval().prepare_inference()
        images = np.load(os.path.join(os.path.dirname(out), "first.npy"))
        torch.save({"launches": launches,
                    "log_probs": first_step_log_probs(torch, model, cfg, images)},
                   f"{out}.{dist.get_rank()}.pt")
    finally:
        dist.destroy_process_group()
    return rc


def main(names) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    if names[:1] == ["kernel"]:  # `chip_smoke.py kernel swin_block ...`
        names = names[1:]
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
        if "swin_mlp_half_a8" in names:
            smoke.a8_product_timing()
        if "downsample" in names:
            smoke.merge_product_timing()
        if "topk" in names:
            smoke.topk_cluster_timing()
        if {"swin_mlp_bwd", "swin_attn_bwd"} & set(names):
            smoke.grad_product_timing()
            smoke.backward_launches()
        log(f"checked and timed {names} only: no result")
        return 0
    smoke.kernels()
    smoke.opcheck_ops()
    smoke.main_path()
    smoke.quant_path()
    smoke.export_path()
    smoke.eval_path()
    smoke.prune_path()
    smoke.parallel_eval_path()
    smoke.train_path()
    smoke.scst_path()
    smoke.train_cli_path()
    smoke.self_check()
    smoke.quant_check()
    smoke.train_check()
    smoke.scst_check()
    smoke.kernel_timing()
    smoke.product_timing()
    smoke.a8_product_timing()
    smoke.merge_product_timing()
    smoke.grad_product_timing()
    smoke.backward_launches()
    smoke.topk_cluster_timing()
    smoke.path_timing()
    smoke.eval_timing()
    smoke.train_timing()
    smoke.scst_timing()
    kernels = []
    for name, k in KERNELS.items():
        by_path = {r: smoke.launches[r][name] for r in smoke.launches}
        kernels.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": by_path[k["paths"][0]],
            "max_abs_err": smoke.errors[name], **smoke.times[name],
            "launches_by_path": by_path, "main_path_cases": smoke.case_times.get(name, []),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
