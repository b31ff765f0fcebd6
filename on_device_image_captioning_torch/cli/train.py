"""Training CLI (counterpart of the JAX package's `cli/train.py`, reference
train.py): XE and SCST phases over COCO or VizWiz, features in or end to end,
with resumable checkpoints.

    python -m on_device_image_captioning_torch.cli.train \\
        --dataset coco --annotations dataset_coco.json --images_path ... \\
        --is_end_to_end --save_path ./saves/ --sched_type custom_warmup_anneal \\
        --optim_type radam [--reinforce [--device_reward]] [--device cpu]

The flags are the JAX CLI's, with its defaults, but for the kernel paths and
the device: `--swin_attention_impl` ("fused", the default, is what the JAX
"auto" picks on its accelerator, or "pallas"), `--step_impl` (the decode step
of SCST sampling and of the eval hook, default "pallas") and `--device`
(default cuda; it raises without a card; `--device cpu` runs the plain
PyTorch versions of every kernel).

- Phases: XE (`train/train_step.py::make_xe_step`); SCST with the host
  reward (`decode/sampling.py::sample`, then `train/scst.py::CiderReward`,
  then `make_scst_step`) or, with `--device_reward`, the shared-encoder step
  (`make_scst_fused_step` over `train/device_cider.py`).
- Optimizers: `radam` is `train/radam.py::RAdam(schedule, 0.9, 0.98, 1e-9)`;
  `adam` and `adamw` follow optax's with their defaults
  (`train/schedules.py::adam`); every one reads the schedule at the count of
  its APPLIED updates (once per `--num_accum` iterations).
- Checkpoints (`utils/checkpointing.py`): every `--save_every_minutes` and at
  the last iteration. A run resumes from the newest checkpoint of
  `--save_path`: the weights, and, if the phase and the batch size are the
  same, the optimizer, the step and the loader cursor (the reference's
  guarded transition, train.py:554-597). A checkpoint of the other model
  kind (features in against end to end) is skipped. With `--prefetch`, the
  cursor saved is the one of the last batch CONSUMED.
- Warm starts: `--pretrain_checkpoint`, `--backbone_save_path`,
  `--body_save_path` (a `.pth` or a native checkpoint; a features-in run
  takes the caption head's part of an end-to-end one).
- Random streams: one `torch.Generator` on the device, seeded `--seed` + 1,
  draws dropout, stochastic depth and the SCST samples; it restarts on
  resume, as the JAX key does. Initial weights: `init_weights` from `--seed`
  on the CPU, whatever the device.
- `--distributed`: data parallel over `torch.distributed`
  (`parallel/mesh.py`), one process per card, from the launcher's RANK,
  WORLD_SIZE, MASTER_ADDR and MASTER_PORT; `--batch_size` is the global
  batch. Rank 0 prints, logs and saves; the others wait. The eval hook runs
  on every rank, each decoding its shard of "val" (`cli/evaluate.py`'s
  `evaluate_split` over the same grid), and rank 0 scores and prints.
- `--n_model N` (with `--distributed`): tensor parallelism over a model axis
  (the JAX CLI's (data, model) mesh and `shard_train_state`): W / N data
  ranks by N model ranks, model groups of consecutive ranks. The loader
  hands each data rank its rows (a model group reads the same ones); the
  warm start and the resume load the whole model, then `shard_model` cuts
  it by the rule table and the optimizer state is cut the same way, then
  DDP wraps the model over the data group (one data rank: no DDP). A
  checkpoint is gathered whole on every rank of each model group and rank
  0 writes it: it loads at any `--n_model`. The start lines say which rules
  cut which layers and the bytes of weights a rank holds; the first step's
  line the bytes of optimizer state it holds.

Two faults of the JAX CLI are not copied: a features-in run warm-started
from a `.pth` reads its caption head (the JAX CLI converts it as an
end-to-end model and fails), and `--scst_max_len` is held to the resolved
`max_seq_len` (the JAX CLI compares it with the flag, None by default).
"""
from __future__ import annotations

import argparse
import dataclasses
import random
import time
from typing import Optional

import numpy as np
import torch

from ..config import ATTENTION_IMPLS
from ..decode.cache import STEP_IMPLS

SWIN = "swin_transf."  # the backbone's prefix in an end-to-end state_dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Image Captioning Training")
    # model (reference train.py:647-656)
    p.add_argument("--model_dim", type=int, default=512)
    p.add_argument("--N_enc", type=int, default=3)
    p.add_argument("--N_dec", type=int, default=3)
    p.add_argument("--ff", type=int, default=2048)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_exp_enc_list", type=int, nargs="+", default=[32, 64, 128, 256, 512])
    p.add_argument("--num_exp_dec", type=int, default=16)
    p.add_argument("--img_feature_dim", type=int, default=1536)
    p.add_argument("--enc_drop", type=float, default=0.1)
    p.add_argument("--dec_drop", type=float, default=0.1)
    p.add_argument("--enc_input_drop", type=float, default=0.1)
    p.add_argument("--dec_input_drop", type=float, default=0.1)
    p.add_argument("--drop_other", type=float, default=0.1)
    p.add_argument("--param_config", type=int, default=0, choices=[0, 1, 2])
    # optimization (reference train.py:657-669)
    p.add_argument("--optim_type", choices=["adam", "radam", "adamw"], default="adam")
    p.add_argument("--sched_type", choices=["annealing", "custom_warmup_anneal"],
                   default="annealing")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--min_lr", type=float, default=5e-7)
    p.add_argument("--warmup_iters", type=int, default=4000)
    p.add_argument("--anneal_coeff", type=float, default=0.8)
    p.add_argument("--anneal_every_epoch", type=float, default=3.0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_accum", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=5)
    # phases
    p.add_argument("--reinforce", action="store_true")
    p.add_argument("--device_reward", action="store_true",
                   help="compute the SCST CIDEr-D reward on the device "
                        "(train/device_cider.py) inside the shared-encoder step: "
                        "no host round trip for the reward")
    p.add_argument("--num_samples", type=int, default=5,
                   help="SCST samples per image (reference train.py:146-151)")
    p.add_argument("--scst_max_len", type=int, default=20)
    p.add_argument("--scst_dropout", action="store_true",
                   help="apply dropout / drop-path during the SCST re-score forward "
                        "(an independent draw around the no-dropout sampling policy; "
                        "see train/train_step.py). Default off: the re-score reproduces "
                        "the sampling log-probs")
    # data
    p.add_argument("--dataset", choices=["coco", "vizwiz"], default="coco")
    p.add_argument("--annotations", type=str, required=True)
    p.add_argument("--images_path", type=str, default="")
    p.add_argument("--features_path", type=str, default=None)
    p.add_argument("--preproc_images_hdf5", type=str, default=None,
                   help="preprocessed uint8 image store (data/images_io.py), "
                        "replaces per-step JPEG decode in end-to-end training")
    p.add_argument("--vocab_path", type=str, default=None)
    p.add_argument("--is_end_to_end", action="store_true")
    p.add_argument("--max_seq_len", type=int, default=None)
    # checkpointing (reference train.py:672-690)
    p.add_argument("--save_path", type=str, default="./saves/")
    p.add_argument("--save_every_minutes", type=int, default=25)
    p.add_argument("--how_many_checkpoints", type=int, default=1)
    p.add_argument("--pretrain_checkpoint", type=str, default=None)
    p.add_argument("--backbone_save_path", type=str, default="")
    p.add_argument("--body_save_path", type=str, default="")
    # eval / logging
    p.add_argument("--eval_every_iter", type=int, default=999999)
    p.add_argument("--eval_beam_sizes", type=int, nargs="+", default=[3])
    p.add_argument("--eval_parallel_batch_size", type=int, default=8)
    p.add_argument("--print_every_iter", type=int, default=10)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--bf16", action="store_true")
    # Swin geometry (defaults = Swin-L/384, the reference's end-to-end model)
    p.add_argument("--swin_img_size", type=int, default=384)
    p.add_argument("--swin_patch_size", type=int, default=4)
    p.add_argument("--swin_embed_dim", type=int, default=192)
    p.add_argument("--swin_depths", type=int, nargs="+", default=[2, 2, 18, 2])
    p.add_argument("--swin_num_heads", type=int, nargs="+", default=[6, 12, 24, 48])
    p.add_argument("--swin_window_size", type=int, default=12)
    p.add_argument("--remat", action="store_true",
                   help="recompute the Swin blocks off the training kernels in the "
                        "backward (torch.utils.checkpoint; the reference's "
                        "swin_use_checkpoint flag)")
    p.add_argument("--metrics_jsonl", type=str, default=None)
    p.add_argument("--swin_attention_impl", choices=ATTENTION_IMPLS, default="fused",
                   help="backbone path: 'fused' (window-resident kernels; the training "
                        "kernels where Swin's drop and attn_drop are 0) or 'pallas'")
    p.add_argument("--step_impl", choices=STEP_IMPLS, default="pallas",
                   help="decode step of SCST sampling and eval-hook beam search")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torch.distributed: one process per card, "
                        "the process group from RANK, WORLD_SIZE, MASTER_ADDR and "
                        "MASTER_PORT (NCCL on cuda, gloo on the CPU)")
    p.add_argument("--n_model", type=int, default=1,
                   help="model-axis size under --distributed: each group of n_model "
                        "consecutive ranks trains one model cut over them (tensor "
                        "parallelism; the FFs, Swin's qkv / proj / MLP on the 'pallas' "
                        "backbone, the vocabulary projection and embedding), DDP over "
                        "the world / n_model data ranks")
    p.add_argument("--prefetch", type=int, default=0,
                   help="prefetch depth: materialize the next batches on a host thread "
                        "while the device computes; 0 = synchronous. Checkpoints store "
                        "the cursor of the last CONSUMED batch, so resume is exact "
                        "either way")
    return p.parse_args(argv)


def build_model_cfg(args, vocab, max_seq_len):
    from ..config import (
        CaptionerConfig,
        DropConfig,
        SwinConfig,
        end_expansionnet_v2_coco,
        remove_layers,
    )

    drop = DropConfig(
        enc=args.enc_drop, dec=args.dec_drop, enc_input=args.enc_input_drop,
        dec_input=args.dec_input_drop, other=args.drop_other,
    )
    cap = CaptionerConfig(
        d_model=args.model_dim, N_enc=args.N_enc, N_dec=args.N_dec, ff=args.ff,
        num_heads=args.num_heads, num_exp_enc_list=tuple(args.num_exp_enc_list),
        num_exp_dec=args.num_exp_dec, vocab_size=len(vocab), max_seq_len=max_seq_len,
        drop=drop, sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
        unk_idx=vocab.unk_idx, img_feature_dim=args.img_feature_dim,
    )
    if args.is_end_to_end:
        cfg = end_expansionnet_v2_coco(
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
        swin = SwinConfig(
            img_size=args.swin_img_size, patch_size=args.swin_patch_size,
            embed_dim=args.swin_embed_dim, depths=tuple(args.swin_depths),
            num_heads=tuple(args.swin_num_heads), window_size=args.swin_window_size,
            drop_path_rate=cfg.swin.drop_path_rate, attention_impl=args.swin_attention_impl,
        )
        cfg = dataclasses.replace(
            cfg, captioner=dataclasses.replace(cap, img_feature_dim=swin.num_features),
            swin=swin)
        return remove_layers(cfg, args.param_config)
    if args.param_config:  # features-in variant of the layer-removal ablations
        cap = dataclasses.replace(
            cap, N_enc=cap.N_enc - (args.param_config >= 1),
            N_dec=cap.N_dec - (args.param_config >= 2))
    return cap


def build_optimizer(params, args, sched):
    from ..train import schedules
    from ..train.radam import RAdam

    if args.optim_type == "radam":
        return RAdam(params, sched, b1=0.9, b2=0.98, eps=1e-9)
    # adamw: optax.adamw's default decay (reference optims/radam.py:240-319)
    return schedules.adam(params, sched, weight_decay=1e-4 if args.optim_type == "adamw" else 0.0)


def caption_head(sd):
    """The caption head's part of a state_dict (all of a caption head's; of an
    end-to-end one, what is not the backbone's): the JAX CLI's `_subtree(src,
    "captioner")`."""
    return {k: v for k, v in sd.items() if not k.startswith(SWIN)}


def backbone(sd):
    """The backbone's part of a state_dict under the end-to-end prefix (an
    end-to-end one's, or a backbone's own, prefixed): `_subtree(src, "swin")`."""
    if any(k.startswith(SWIN) for k in sd):
        return {k: v for k, v in sd.items() if k.startswith(SWIN)}
    return {SWIN + k: v for k, v in sd.items()}


def same_model(a, b) -> bool:
    """Whether two state_dicts hold the same parameters, key for key and shape
    for shape."""
    return a.keys() == b.keys() and all(tuple(a[k].shape) == tuple(b[k].shape) for k in a)


def release_inference_layout(model) -> None:
    """Drop what `prepare_inference` laid out (the bf16 operands of the fused
    blocks, the expanded relative-position biases): stale once the weights
    change, and memory held through training."""
    for m in model.modules():
        if hasattr(m, "fused_cache"):
            m.fused_cache = None
        if hasattr(m, "rel_bias_x"):
            m.rel_bias_x = None


def warm_start(model, args) -> None:
    """--pretrain_checkpoint, then --backbone_save_path / --body_save_path
    (JAX `cli/train.py:269-295`). A features-in model takes the caption
    head's part of any of them, an end-to-end model's included (where the
    JAX CLI fails on a `.pth`: ROADMAP C12)."""
    from ..params import surgery
    from ..params.convert import load_reference_state_dict
    from .demo import load_params

    end2end = args.is_end_to_end
    if args.pretrain_checkpoint:
        loaded = load_params(args.pretrain_checkpoint)
        if not end2end:
            loaded = caption_head(loaded)
        elif args.param_config:
            loaded = surgery.remove_layer(loaded, args.param_config)
        load_reference_state_dict(model, loaded)
    if end2end:
        for path, part in ((args.backbone_save_path, backbone),
                           (args.body_save_path, caption_head)):
            if path:
                model.load_state_dict(surgery.partially_load(model.state_dict(),
                                                             part(load_params(path))))
    elif args.body_save_path:
        model.load_state_dict(caption_head(load_params(args.body_save_path)))


def resume(model, opt, loader, args, phase: str, verbose: bool) -> int:
    """Resume from the newest checkpoint of --save_path (reference
    train.py:530-560, utils/saving_utils.py); returns the step to start at.
    The guarded transition (train.py:554-597): a phase flip XE <-> RF or
    another batch size keeps only the weights; a checkpoint of the other
    model kind is skipped (the recipe's phases alternate the two kinds in
    one directory, reference README.md:117-259, and the warm starts carry
    the weights across)."""
    from ..utils import checkpointing as ckpt

    payload, info = ckpt.load_most_recent(args.save_path, verbose=verbose)
    if payload is None:
        return 0
    if not same_model(payload["params"], model.state_dict()):
        print("most recent checkpoint holds a different model (features-only vs end-to-end); "
              "starting from warm-start/init weights instead", flush=True)
        return 0
    model.load_state_dict(payload["params"])
    dls = payload.get("data_loader_state") or {}
    if info != phase or dls.get("batch_size") != args.batch_size:
        print(f"phase/batch-size change ({info}->{phase}): keeping weights, resetting "
              "optimizer and data cursor", flush=True)
        return 0
    opt.load_state_dict(payload["opt_state"])
    if dls:
        loader.load_state(dls)
    return int(payload["step"])


def main(argv=None):
    args = parse_args(argv)
    from ..data.datasets import load_coco_karpathy, load_vizwiz
    from ..data.loader import ShardedCaptionLoader
    from ..data.text import Vocab
    from ..models.captioner import ExpansionNetV2
    from ..models.end_to_end import EndExpansionNetV2, init_weights
    from ..parallel import mesh as pm
    from ..train import schedules, train_step
    from ..train.scst import CiderReward
    from ..utils import checkpointing as ckpt
    from ..utils.image import normalize_on_device, preprocess_batch
    from ..utils.profiling import MetricsLogger, StepTimer
    from .demo import resolve_device

    device = resolve_device(args.device)
    joined = args.distributed and not pm.is_distributed()  # a caller's group stays
    if args.distributed:
        device = pm.init_distributed(device)
    rank = pm.process_index()
    grid = pm.make_grid(args.n_model)
    random.seed(args.seed)
    np.random.seed(args.seed)

    # ---- data -------------------------------------------------------------
    vocab = Vocab.from_json(args.vocab_path) if args.vocab_path else None
    if args.dataset == "coco":
        dataset = load_coco_karpathy(args.annotations, args.images_path, vocab=vocab)
    else:
        dataset = load_vizwiz(args.annotations, args.images_path, vocab=vocab)
    vocab = dataset.vocab
    max_seq_len = args.max_seq_len or dataset.max_seq_len
    if args.reinforce and args.scst_max_len > max_seq_len:
        # the decoder's learned positional table has max_seq_len rows
        raise SystemExit(
            f"--scst_max_len {args.scst_max_len} exceeds max_seq_len {max_seq_len} (the "
            "decoder's positional-embedding budget); lower scst_max_len or raise max_seq_len")
    mode = "image_wise" if args.reinforce else "caption_wise"
    loader = ShardedCaptionLoader(
        dataset, array_of_init_seeds=[args.seed + e for e in range(args.num_epochs * 2)],
        batch_size=args.batch_size, rank=grid.data_rank, num_procs=grid.n_data, mode=mode)
    store = img_store = None
    if args.features_path:
        from ..data.features_io import FeatureStore

        store = FeatureStore(args.features_path)
    if args.preproc_images_hdf5:
        from ..data.images_io import PreprocessedImageStore

        img_store = PreprocessedImageStore(args.preproc_images_hdf5)

    # ---- model ------------------------------------------------------------
    cfg = build_model_cfg(args, vocab, max_seq_len)
    end2end = args.is_end_to_end
    cap_cfg = cfg.captioner if end2end else cfg
    model = EndExpansionNetV2(cfg) if end2end else ExpansionNetV2(cfg)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    warm_start(model, args)
    model.to(device)

    # ---- optimizer --------------------------------------------------------
    num_batches = loader.get_num_batches()
    if args.sched_type == "annealing":
        sched = schedules.annealing(args.lr, args.warmup_iters, args.anneal_every_epoch,
                                    num_batches, args.anneal_coeff)
    else:
        sched = schedules.custom_warmup_anneal(args.lr, args.warmup_iters, args.min_lr,
                                               args.anneal_coeff, args.anneal_every_epoch,
                                               num_batches)
    def optimizer():
        return train_step.with_grad_accum(build_optimizer(model.parameters(), args, sched),
                                          args.num_accum)

    opt = optimizer()
    phase = "rf" if args.reinforce else "xe"
    step = resume(model, opt, loader, args, phase, verbose=rank == 0)

    # ---- model axis: cut the whole model and its optimizer state ---------
    if grid.n_model > 1:
        whole_state = opt.state_dict()
        lines = pm.shard_model(model, grid)
        opt = optimizer()  # on the cut parameters
        opt.load_state_dict(pm.cut_optimizer_state(whole_state, model))
        del whole_state
        if rank == 0:
            print("\n".join(lines), flush=True)

    # ---- data parallel (the reference's mp.spawn + DDP, train.py:616-643) --
    net = model
    if grid.n_data > 1:
        net = pm.DataParallel(model, device, grid.data_group)
        if rank == 0:
            print(f"DDP over {net.world} data ranks ({device.type})", flush=True)

    # ---- steps ------------------------------------------------------------
    xe_step = train_step.make_xe_step(net, cfg, opt, remat=args.remat)
    if args.reinforce:
        train_refs = [r["captions"] for r in dataset.records("train")]
        if args.device_reward:
            from ..train.device_cider import DeviceCiderCorpus

            dcorpus = DeviceCiderCorpus(train_refs, vocab)
            scst_fused = train_step.make_scst_fused_step(
                net, cfg, opt, args.num_samples, args.scst_max_len, vocab.sos_idx,
                vocab.eos_idx, dcorpus.make_reward_fn(device), dropout=args.scst_dropout,
                step_impl=args.step_impl, remat=args.remat)
        else:
            from ..decode import sampling

            scst_step = train_step.make_scst_step(net, cfg, opt, args.num_samples,
                                                  remat=args.remat)
            reward_fn = CiderReward(train_refs)

            @torch.no_grad()
            def sample_batch(arrays, generator):
                pads = arrays.get("enc_num_pads")
                enc = (model.forward_enc(arrays["enc_input"]) if end2end
                       else model.forward_enc(arrays["enc_input"], pads))
                return sampling.sample(model, cap_cfg, enc, args.num_samples,
                                       args.scst_max_len, vocab.sos_idx, vocab.eos_idx,
                                       enc_num_pads=pads, step_impl=args.step_impl,
                                       generator=generator)

    def materialize(batch):
        """A loader batch -> this rank's tensors on the device."""
        ids = batch["img_idxs"]
        if end2end:
            if img_store is not None:
                imgs = img_store.read_batch(loader.image_ids(ids))
            else:
                imgs = preprocess_batch(loader.image_paths(ids), cfg.swin.img_size)
            arrays = {"enc_input": normalize_on_device(torch.from_numpy(imgs).to(device))}
        else:
            feats, pads = store.read_batch(loader.image_ids(ids))
            arrays = {"enc_input": torch.from_numpy(np.asarray(feats)),
                      "enc_num_pads": torch.tensor(pads, dtype=torch.int32)}
        if "captions" in batch:
            arrays["captions"] = torch.tensor(batch["captions"], dtype=torch.long)
        return {k: v.to(device) for k, v in arrays.items()}

    # ---- loop (reference train.py:47-302) ---------------------------------
    total_iters = args.num_epochs * num_batches
    last_save = time.time()
    running = []
    timer = StepTimer(warmup=2)
    logger = MetricsLogger(args.metrics_jsonl if rank == 0 else None, stdout=False)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    state_line = grid.n_model > 1 and rank == 0  # the optimizer state a rank holds
    if rank == 0:
        print(f"training: {total_iters} iters ({num_batches}/epoch), "
              f"{'end-to-end' if end2end else 'features'}, "
              f"{'SCST' if args.reinforce else 'XE'}", flush=True)
    prefetcher = None
    if args.prefetch > 0:
        from ..data.prefetch import PrefetchIterator

        prefetcher = PrefetchIterator(lambda: loader.get_next_batch(max_seq_len), materialize,
                                      depth=args.prefetch, snapshot=loader.save_state)

    try:
        for it in range(step, total_iters):
            if prefetcher is not None:
                batch, arrays = prefetcher.get()
            else:
                batch = loader.get_next_batch(max_seq_len)
                arrays = materialize(batch)
            if not args.reinforce:
                running.append(float(xe_step(arrays, gen)["loss"]))
            elif args.device_reward:
                # the only host work: gathering this batch's reference tables
                metrics = scst_fused(arrays, dcorpus.batch(batch["img_idxs"]), gen)
                running.append(float(metrics["reward"]))
            else:
                sampled = sample_batch(arrays, gen)
                # rank-local: this rank's samples align with its loader rows
                rewards = reward_fn(sampled.tokens, sampled.lengths, batch["img_idxs"], vocab)
                metrics = scst_step(arrays, {"tokens": sampled.tokens,
                                             "lengths": sampled.lengths},
                                    rewards, gen if args.scst_dropout else None)
                running.append(float(metrics["reward"]))
            step = it + 1
            if state_line and (line := optimizer_state_line(opt, model)):
                print(line, flush=True)  # once: the first step allocates the state
                state_line = False

            timer.tick()
            if step % args.print_every_iter == 0 and rank == 0:
                tag = "reward" if args.reinforce else "loss"
                # the schedule counts APPLIED updates: once per num_accum iterations
                stats = {
                    tag: float(np.mean(running)),
                    "lr": float(sched(step // max(args.num_accum, 1))),
                    "sec_per_iter": timer.sec_per_iter,
                    "pct_done": 100.0 * step / total_iters,
                }
                print(f"it {step}/{total_iters} epoch {loader.get_epoch_it()} "
                      f"{tag} {stats[tag]:.4f} lr {stats['lr']:.3e} "
                      f"{stats['sec_per_iter']:.3f}s/it {stats['pct_done']:.1f}%", flush=True)
                logger.log(step, stats)
            if step % args.print_every_iter == 0:
                running = []

            due = (time.time() - last_save) / 60 >= args.save_every_minutes
            if pm.any_rank(due, device) or step == total_iters:
                # whole on every rank: gathered over each model group
                params = pm.gather_state_dict(model, grid)
                opt_state = pm.gather_optimizer_state(opt.state_dict(), model, grid)
                if rank == 0:
                    # with prefetch the loader runs ahead of consumption: save
                    # the cursor of the last batch consumed (reference
                    # data/transparent_data_loader.py:49-61)
                    dls = prefetcher.consumed_state if prefetcher is not None else (
                        loader.save_state())
                    ckpt.save_checkpoint(
                        args.save_path, params, opt_state, step,
                        data_loader_state=dls,
                        additional_info=phase, num_max_checkpoints=args.how_many_checkpoints,
                        epoch_it=dls["epoch_it"], batch_it=dls["batch_it"],
                        batch_size=dls["batch_size"], verbose=True)
                del params, opt_state
                pm.barrier()
                last_save = time.time()

            if step % args.eval_every_iter == 0:
                evaluate_val(model, cfg, dataset, args, max_seq_len, grid)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if store is not None:
            store.close()
        if img_store is not None:
            img_store.close()
        logger.close()
        if joined:
            pm.shutdown()
    return 0


def optimizer_state_line(opt, model) -> Optional[str]:
    """The line of the optimizer state a rank holds beside the whole state's
    bytes; None while the optimizer holds nothing (before its first step
    allocates the moments)."""
    from ..parallel import mesh as pm

    held, whole = pm.optimizer_state_bytes(opt.state_dict(), model)
    return f"  optimizer state a rank holds: {held} bytes of {whole} whole" if held else None


def evaluate_val(model, cfg, dataset, args, max_seq_len, grid=None) -> None:
    """The eval hook: `evaluate_split` on "val" at each `--eval_beam_sizes`,
    on the current weights (the inference layout is laid out anew, and
    dropped after), then back to training. Under `--distributed` every rank
    decodes its data rank's rows of the split (`grid`) and rank 0 scores and
    prints."""
    from ..parallel import mesh as pm
    from .evaluate import evaluate_split

    model.eval()
    if args.is_end_to_end:
        model.prepare_inference()
    try:
        for beam in args.eval_beam_sizes:
            scores, _ = evaluate_split(model, cfg, dataset, "val", beam,
                                       args.eval_parallel_batch_size, max_seq_len,
                                       args.features_path, step_impl=args.step_impl,
                                       grid=grid)
            if pm.process_index() == 0:
                print(f"[eval beam {beam}] {scores}", flush=True)
    finally:
        release_inference_layout(model)
        model.train()


if __name__ == "__main__":
    raise SystemExit(main())
