"""Batch evaluation CLI (counterpart of the JAX package's `cli/evaluate.py`,
reference test.py): beam-decode a COCO-Karpathy or VizWiz split on the card
and score it with the metric suite, per beam size.

    python -m on_device_image_captioning_torch.cli.evaluate --device cuda \
        --dataset coco --annotations dataset_coco.json --images_path ... \
        --vocab_path vocab.json --load_path rf_model.pth --split test \
        --beam_sizes 3 5 [--features_path features.hdf5] [--dump_predictions p.json]

Checkpoints are `.pth` state_dicts in the reference's parameter names, or
native checkpoints (`utils/checkpointing.py`, which `cli/train.py` writes),
or with `--load_pruned` sparse npz files (`deploy/pruning.py::save_sparse`,
densified over a model of the configured shape): the end-to-end model, or
the caption head alone with `--features_path`. Several `--load_path`s decode
as an ensemble. They load in this order: the state_dict, the layer-removal
surgery of `--param_config` on a full-stack checkpoint (`params/surgery.py`),
`--quantize`, and the inference layout of an end-to-end model. `--device cuda` is the default and raises without a
card. `--swin_attention_impl` picks the backbone path ("fused", the default,
is the window-resident one) and `--step_impl` the decode step, the choices
the JAX CLI's "auto" makes on its accelerator. The scorers run on the host;
METEOR and SPICE are the native ones unless METEOR_JAR / SPICE_JAR name jars.

The loop is a software pipeline: a worker thread materializes the next batch
on the host (image decode or feature-store read, and the tail padding) while
the card decodes the current one, and the previous batch's captions are
drained after the next decode has been issued. The last batch is padded to
the batch size by repeating its last row, so that every batch runs on the
same launch plans.

`--distributed` evaluates over a world of processes, one a card (torchrun, or
any launcher that exports RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT),
cut into `W / n_model` data ranks by `--n_model` model ranks
(`parallel/mesh.py`): each data rank decodes its `batch_size / n_data` rows
of every global batch (its last one padded by the same rule), the ranks of a
model group decode the same rows on a model cut over them (tensor
parallelism, collectives inside the group only), and the predictions, keyed
by image id, are gathered to rank 0, which alone scores, prints and writes
`--dump_predictions`. `--eval_loss` sums over the data ranks.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time

import numpy as np
import torch
from torch import nn

from ..config import ATTENTION_IMPLS
from ..decode.cache import STEP_IMPLS
from ..utils.image import preprocess_batch


def build_dataset(args):
    from ..data.datasets import load_coco_karpathy, load_vizwiz
    from ..data.text import Vocab

    vocab = Vocab.from_json(args.vocab_path) if args.vocab_path else None
    if args.dataset == "coco":
        return load_coco_karpathy(args.annotations, args.images_path, vocab=vocab)
    return load_vizwiz(args.annotations, args.images_path, vocab=vocab)


def decode_view(model):
    """The model as the JAX CLI decodes with it (`dequantize_tree` of the
    caption head): its decoder's weight-only int8 linears dequantized to bf16
    values, in a copy of the decoder side; the encoder side is shared and the
    model is left as it is. A model without such linears is returned."""
    from ..deploy.quantization import DECODER_PAT, QuantLinear, dequantize_model

    if not any(isinstance(m, QuantLinear) and m.mode == "w8" and DECODER_PAT.search(n)
               for n, m in model.named_modules()):
        return model
    side = nn.ModuleDict({n: model._modules[n]
                          for n in ("decoders", "vocab_linear", "dec_reduce_group")})
    view = copy.copy(model)
    view._modules = {**model._modules, **dequantize_model(copy.deepcopy(side))}
    return view


def evaluate_split(
    model_or_models, cfg, dataset, split: str, beam_size: int, batch_size: int,
    max_seq_len: int, features_path: str | None = None, verbose: bool = True,
    metrics=("bleu", "rouge", "cider"), step_impl: str = "pallas",
    load_images=preprocess_batch, feature_store=None, grid=None,
):
    """Decode every image of a split and score. Returns (scores, predictions).

    (reference test.py:141-275 evaluate_model.) `model_or_models`: an
    `EndExpansionNetV2` with its `ModelConfig`, or (`features_path` set) an
    `ExpansionNetV2` with its `CaptionerConfig`; a list decodes as an
    ensemble. The models are ready on their device (`prepare_inference` done
    for end-to-end ones). `load_images(paths, size)` gives the uint8 NHWC
    images of a batch; `feature_store` (an object with `read_batch(img_ids)`
    -> (features, pads)) takes the place of the store at `features_path`.
    `grid` (`parallel/mesh.py::make_grid`; the models already cut over its
    model axis): this rank decodes its data rank's rows of each global
    batch of `batch_size`, and the predictions are gathered to rank 0, which
    alone scores; the other ranks return ({}, {}).
    """
    from ..config import DecodeConfig
    from ..data.features_io import FeatureStore
    from ..data.prefetch import PrefetchIterator
    from ..decode import beam_search as bs
    from ..evalcap.harness import evaluate_captions
    from ..parallel import mesh as pm
    from ..utils.image import normalize_on_device

    vocab = dataset.vocab
    records = dataset.records(split)
    end2end = features_path is None
    grid = grid or pm.Grid()
    parallel = grid.n_data * grid.n_model > 1
    local_batch = _local_batch(batch_size, grid)
    models = list(model_or_models) if isinstance(model_or_models, (list, tuple)) else [
        model_or_models]
    dev = next(models[0].parameters()).device
    dcfg = DecodeConfig(
        beam_size=beam_size, how_many_outputs=1, max_seq_len=max_seq_len,
        sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx,
    )
    views = [decode_view(m) for m in models]
    cap_cfg = cfg.captioner if end2end else cfg
    dtype = cfg.compute_dtype if end2end else None

    @torch.inference_mode()
    def decode_batch(arrays):
        if end2end:
            x = normalize_on_device(torch.from_numpy(arrays["x"]).to(dev))
            encs, pads = [m.forward_enc(x) for m in models], None
        else:
            feats = torch.from_numpy(arrays["f"]).to(dev)
            pads = torch.from_numpy(arrays["p"]).to(dev)
            encs = [m.forward_enc(feats, pads) for m in models]
        return bs.ensemble_beam_search(views, cap_cfg, encs, dcfg, dtype=dtype,
                                       enc_num_pads=pads, step_impl=step_impl)

    store = None
    if not end2end:
        store = feature_store if feature_store is not None else FeatureStore(features_path)
    predictions = {}
    t0 = time.time()

    def batches():
        for _, chunk in _local_chunks(records, batch_size, grid):
            pad_rows = local_batch - len(chunk)  # static batch: pad the tail
            if end2end:
                imgs = load_images([r["img_path"] for r in chunk], cfg.swin.img_size)
                if pad_rows:
                    imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad_rows, 0)])
                yield chunk, {"x": imgs}
            else:
                feats, fpads = store.read_batch([r["img_id"] for r in chunk])
                fpads = np.asarray(fpads, np.int32)
                if pad_rows:
                    feats = np.concatenate([feats, np.repeat(feats[-1:], pad_rows, 0)])
                    fpads = np.concatenate([fpads, np.repeat(fpads[-1:], pad_rows, 0)])
                yield chunk, {"f": feats, "p": fpads}

    done = 0

    def drain(pending):
        nonlocal done
        chunk, res = pending
        caps, _ = bs.captions_from_result(res)
        for r, row in zip(chunk, caps):
            predictions[r["img_id"]] = vocab.description(row[0]).lower()
        done += len(chunk)
        if verbose and not parallel:
            print(
                f"decoded {done}/{len(records)} "
                f"({done / max(time.time() - t0, 1e-9):.2f} img/s)",
                flush=True,
            )

    it = iter(batches())
    prefetch = PrefetchIterator(next_batch=lambda: next(it), materialize=lambda b: b, depth=2)
    pending = None
    try:
        while True:
            try:
                (chunk, arrays), _ = prefetch.get()
            except StopIteration:
                break
            res = decode_batch(arrays)
            if pending is not None:
                drain(pending)
            pending = (chunk, res)
        if pending is not None:
            drain(pending)
    finally:
        prefetch.close()
        if store is not None and feature_store is None:
            store.close()

    if parallel:
        predictions = pm.gather_predictions(predictions)
        if pm.process_index() != 0:
            return {}, {}
        predictions = {r["img_id"]: predictions[r["img_id"]] for r in records}
        if verbose:
            wall = time.time() - t0
            print(f"decoded {len(records)} images in {wall:.3f} s "
                  f"({len(records) / max(wall, 1e-9):.2f} img/s) on {grid.n_data} data "
                  f"ranks x {grid.n_model} model ranks", flush=True)
    references = {r["img_id"]: r["captions"] for r in records if r["captions"]}
    preds_for_eval = {i: predictions[i] for i in references}
    scores = evaluate_captions(preds_for_eval, references, metrics=metrics, verbose=verbose)
    return scores, predictions


def _local_batch(batch_size: int, grid) -> int:
    """The rows a data rank decodes of each global batch."""
    if batch_size % grid.n_data:
        raise SystemExit(f"--batch_size {batch_size} (the global batch) does not split over "
                         f"{grid.n_data} data ranks")
    return batch_size // grid.n_data


def _local_chunks(records, batch_size: int, grid):
    """(global batch index, this data rank's records of that batch of
    `batch_size`: its `batch_size / n_data` consecutive rows); a rank whose
    rows of the last batch all lie past the split's end gets no chunk of it."""
    local = _local_batch(batch_size, grid)
    for i, start in enumerate(range(0, len(records), batch_size)):
        first = start + grid.data_rank * local
        chunk = records[first : min(first + local, start + batch_size)]
        if chunk:
            yield i, chunk


@torch.inference_mode()
def compute_evaluation_loss(
    model, cfg, dataset, split: str, batch_size: int, features_path: str | None = None,
    load_images=preprocess_batch, feature_store=None, grid=None,
):
    """Mean label-smoothing loss over a split (reference test.py:80-138): the
    first reference of each image, teacher-forced; each batch's loss is its
    mean over the batch's non-pad tokens, weighted by the batch's images.
    `grid`: this rank takes its data rank's rows of each batch, and the
    batches' sums and token counts are summed over the data ranks."""
    from ..data.features_io import FeatureStore
    from ..data.text import pad_batch
    from ..parallel import mesh as pm
    from ..train.losses import label_smoothing_loss
    from ..utils.image import normalize_on_device

    vocab = dataset.vocab
    records = dataset.records(split)
    end2end = features_path is None
    dev = next(model.parameters()).device
    store = None
    if not end2end:
        store = feature_store if feature_store is not None else FeatureStore(features_path)

    grid = grid or pm.Grid()
    starts = range(0, len(records), batch_size)
    sums = torch.zeros((len(starts), 2), dtype=torch.float64, device=dev)
    try:
        for i, chunk in _local_chunks(records, batch_size, grid):
            caps = [vocab.encode_caption(r["captions"][0]) for r in chunk]
            padded, _ = pad_batch(caps, vocab.pad_idx)
            toks = torch.tensor(padded, dtype=torch.int32, device=dev)
            dec_in, targets = toks[:, :-1], toks[:, 1:]
            dec_pads = (dec_in == vocab.pad_idx).sum(dim=-1)
            if end2end:
                imgs = load_images([r["img_path"] for r in chunk], cfg.swin.img_size)
                x = normalize_on_device(torch.from_numpy(imgs).to(dev))
                logits = model(x, dec_in, dec_num_pads=dec_pads)
                pad_idx = cfg.captioner.pad_idx
            else:
                feats, fpads = store.read_batch([r["img_id"] for r in chunk])
                logits = model(torch.from_numpy(feats).to(dev), dec_in,
                               enc_num_pads=torch.tensor(fpads, device=dev),
                               dec_num_pads=dec_pads)
                pad_idx = cfg.pad_idx
            sums[i, 0] = label_smoothing_loss(logits, targets, pad_idx,
                                              divide_by_non_pads=False).double()
            sums[i, 1] = (targets != pad_idx).sum()
    finally:
        if store is not None and feature_store is None:
            store.close()
    sums = pm.all_reduce_sum(sums, grid.data_group)
    images = torch.tensor([len(records[s:s + batch_size]) for s in starts],
                          dtype=torch.float64, device=dev)
    per_batch = sums[:, 0] / sums[:, 1].clamp_min(1)
    return float((per_batch * images).sum()) / max(len(records), 1)


def load_state_dicts(args, template=None):
    """The `--load_path` state_dicts (`cli/demo.py::load_params`: a `.pth`
    cleaned of the reference's DDP prefix and buffers, or a native
    checkpoint's params); a full-stack one gets the layer-removal surgery of
    `--param_config` (reference train.py:305-342); one already saved in
    reduced form passes through untouched. With `--load_pruned` each path is
    a sparse npz (`deploy/pruning.py::save_sparse`), densified over the
    state_dict `template` of a model of the configured shape (no surgery:
    the template has it)."""
    from ..params import surgery
    from .demo import load_params

    if args.load_pruned:
        from ..deploy.pruning import load_sparse

        return [load_sparse(path, template) for path in args.load_path]
    sds = []
    for path in args.load_path:
        sd = load_params(path)
        if args.param_config and surgery.stack_depth(sd, "encoders") == args.N_enc:
            sd = surgery.remove_layer(sd, args.param_config)
        sds.append(sd)
    return sds


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation")
    parser.add_argument("--dataset", choices=["coco", "vizwiz"], default="coco")
    parser.add_argument("--annotations", type=str, required=True)
    parser.add_argument("--images_path", type=str, default="")
    parser.add_argument("--features_path", type=str, default=None,
                        help="HDF5 feature store; when set, evaluates the "
                             "features-in model instead of end-to-end")
    parser.add_argument("--vocab_path", type=str, default=None)
    parser.add_argument("--load_path", type=str, nargs="+", required=True,
                        help="one checkpoint (.pth state_dict or native), or several "
                             "for ensemble decoding")
    parser.add_argument("--split", default="test", choices=["val", "test"])
    parser.add_argument("--beam_sizes", type=int, nargs="+", default=[3])
    parser.add_argument("--metrics", type=str, nargs="+",
                        default=["bleu", "meteor", "rouge", "cider", "spice"],
                        choices=["bleu", "meteor", "rouge", "cider", "spice"],
                        help="scorers to run (the reference's COCOEvalCap runs "
                             "all five by default, eval/eval.py:33-67; METEOR "
                             "and SPICE use the native scorers unless "
                             "METEOR_JAR/SPICE_JAR are set)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_seq_len", type=int, default=74)
    parser.add_argument("--param_config", type=int, default=0, choices=[0, 1, 2])
    parser.add_argument("--model_dim", type=int, default=512)
    parser.add_argument("--N_enc", type=int, default=3)
    parser.add_argument("--N_dec", type=int, default=3)
    parser.add_argument("--ff", type=int, default=2048)
    parser.add_argument("--num_heads", type=int, default=8)
    parser.add_argument("--num_exp_enc_list", type=int, nargs="+",
                        default=[32, 64, 128, 256, 512])
    parser.add_argument("--num_exp_dec", type=int, default=16)
    parser.add_argument("--img_feature_dim", type=int, default=1536)
    # Swin geometry (defaults = Swin-L/384; overridable for small configs/tests)
    parser.add_argument("--swin_img_size", type=int, default=384)
    parser.add_argument("--swin_patch_size", type=int, default=4)
    parser.add_argument("--swin_embed_dim", type=int, default=192)
    parser.add_argument("--swin_depths", type=int, nargs="+", default=[2, 2, 18, 2])
    parser.add_argument("--swin_num_heads", type=int, nargs="+", default=[6, 12, 24, 48])
    parser.add_argument("--swin_window_size", type=int, default=12)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--quantize", choices=["none", "w8", "w8a8"], default="none")
    parser.add_argument("--load_pruned", action="store_true",
                        help="--load_path names sparse .npz files written by "
                             "deploy/pruning.py::save_sparse (reference test.py:455-459)")
    parser.add_argument("--eval_loss", action="store_true")
    parser.add_argument("--dump_predictions", type=str, default=None,
                        help="write decoded captions as JSON "
                             "{beam_size: {img_id: caption}} (the captions the "
                             "reference prints per image at test.py:216-224)")
    parser.add_argument("--swin_attention_impl", choices=ATTENTION_IMPLS, default="fused",
                        help="backbone path: 'fused' (window-resident kernels) or 'pallas'")
    parser.add_argument("--step_impl", choices=STEP_IMPLS, default="pallas",
                        help="decode-step path: 'pallas' or 'pallas_fused'")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--distributed", action="store_true",
                        help="evaluate over torch.distributed: one process per card, the "
                             "process group from RANK, WORLD_SIZE, MASTER_ADDR and "
                             "MASTER_PORT (NCCL on cuda, gloo on the CPU); --batch_size "
                             "stays the global batch, split over the data ranks")
    parser.add_argument("--n_model", type=int, default=1,
                        help="model-axis size under --distributed: each group of n_model "
                             "consecutive ranks serves one model cut over them (tensor "
                             "parallelism; the FFs, Swin's qkv / proj / MLP on the 'pallas' "
                             "backbone, the vocabulary projection and embedding). Not with "
                             "--quantize (ROADMAP A9); the 'fused' backbone keeps its blocks "
                             "whole (ROADMAP A10)")
    args = parser.parse_args(argv)

    from ..parallel import mesh as pm
    from .demo import resolve_device

    pm.check_model_axis(args.n_model, quantize=args.quantize)
    device = resolve_device(args.device)
    joined = args.distributed and not pm.is_distributed()  # a caller's group stays
    if args.distributed:
        device = pm.init_distributed(device)
    try:
        return _evaluate(args, device)
    finally:
        if joined:
            pm.shutdown()


def _evaluate(args, device) -> int:
    from ..config import CaptionerConfig, ModelConfig, SwinConfig, remove_layers
    from ..deploy.quantization import load_quantized_state_dict, quantize_model
    from ..models.captioner import ExpansionNetV2
    from ..models.end_to_end import EndExpansionNetV2
    from ..parallel import mesh as pm

    grid = pm.make_grid(args.n_model)
    rank0 = pm.process_index() == 0
    dataset = build_dataset(args)
    vocab = dataset.vocab
    cap = CaptionerConfig(
        d_model=args.model_dim, N_enc=args.N_enc, N_dec=args.N_dec, ff=args.ff,
        num_heads=args.num_heads, num_exp_enc_list=tuple(args.num_exp_enc_list),
        num_exp_dec=args.num_exp_dec, vocab_size=len(vocab),
        max_seq_len=args.max_seq_len, img_feature_dim=args.img_feature_dim,
        sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
        unk_idx=vocab.unk_idx,
    )
    if args.features_path:
        cfg = cap  # features-in CaptionerConfig
        if args.param_config:
            cfg = dataclasses.replace(
                cfg,
                N_enc=cfg.N_enc - (args.param_config >= 1),
                N_dec=cfg.N_dec - (args.param_config >= 2),
            )
        model_cls = ExpansionNetV2
    else:
        swin = SwinConfig(
            img_size=args.swin_img_size, patch_size=args.swin_patch_size,
            embed_dim=args.swin_embed_dim, depths=tuple(args.swin_depths),
            num_heads=tuple(args.swin_num_heads), window_size=args.swin_window_size,
            attention_impl=args.swin_attention_impl,
        )
        cfg = ModelConfig(
            swin=swin,
            captioner=dataclasses.replace(cap, img_feature_dim=swin.num_features),
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        )
        cfg = remove_layers(cfg, args.param_config)
        model_cls = EndExpansionNetV2

    models = []
    template = None
    if args.load_pruned:
        with torch.device("meta"):  # names and dtypes only
            template = model_cls(cfg).state_dict()
    for sd in load_state_dicts(args, template):
        model = load_quantized_state_dict(model_cls(cfg), sd)
        if args.quantize != "none":
            quantize_model(model, args.quantize)
        lines = pm.shard_model(model, grid)
        if rank0 and not models:
            print("\n".join(lines), flush=True)
        model.to(device).eval()
        if isinstance(model, EndExpansionNetV2):
            model.prepare_inference()
        models.append(model)
    model = models[0] if len(models) == 1 else models

    dumped = {}
    for beam in args.beam_sizes:
        if rank0:
            print(f"=== beam size {beam} ===", flush=True)
        scores, predictions = evaluate_split(
            model, cfg, dataset, args.split, beam, args.batch_size,
            args.max_seq_len, args.features_path, metrics=tuple(args.metrics),
            step_impl=args.step_impl, grid=grid,
        )
        for k, v in scores.items():
            print(f"{k}: {v:.4f}", flush=True)
        dumped[beam] = {str(k): v for k, v in predictions.items()}
    if args.dump_predictions and rank0:
        import json

        with open(args.dump_predictions, "w") as f:
            json.dump(dumped, f, indent=1)
        print(f"predictions written to {args.dump_predictions}", flush=True)
    if args.eval_loss:
        loss = compute_evaluation_loss(
            models[0], cfg, dataset, args.split, args.batch_size, args.features_path,
            grid=grid,
        )
        if rank0:
            print(f"eval loss: {loss:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
