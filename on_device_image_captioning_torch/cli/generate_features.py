"""Feature extraction CLI (counterpart of the JAX package's
`cli/generate_features.py`, reference data_generator.py): run the Swin
backbone over every image of a dataset on the card and write a
"{img_id}_features" HDF5 store for the features-in paths.

    python -m on_device_image_captioning_torch.cli.generate_features --device cuda \
        --dataset coco --annotations dataset_coco.json --images_path ... \
        --backbone_checkpoint swin.pth --output features.hdf5 [--feature_dtype float16]

`--backbone_checkpoint` takes a `.pth` (the end-to-end model's state_dict, a
Swin-official file ({'model': ...}) or the backbone's own state_dict) or a
native checkpoint of either model (`utils/checkpointing.py`); without one
the backbone gets seeded random weights. The backbone runs its config's
default path ("pallas"). `--device cuda` is the default and raises without a
card.

The loop is a three-stage software pipeline: a worker thread decodes and
resizes the next batch on the host while the card computes the current one
and the host drains the previous result into the store (the reference
extracts one image at a time, data_generator.py:98-160). The last batch is
padded to the batch size by repeating its last image.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch import nn

from ..utils.image import preprocess_batch


@torch.inference_mode()
def extract_features(model: nn.Module, images_u8, dtype, store_dtype) -> torch.Tensor:
    """One batch: uint8 NHWC images (numpy or tensor) -> backbone features
    (B, tokens, num_features) on the model's device. A float16 store gets them
    cast on the device, so the transfer carries 2-byte elements; a float32
    store gets the compute dtype as it is (upcast on the host when drained)."""
    from ..utils.image import normalize_on_device

    dev = next(model.parameters()).device
    x = normalize_on_device(torch.as_tensor(images_u8).to(dev))
    y = model(x, dtype)
    return y.to(torch.float16) if np.dtype(store_dtype) == np.float16 else y


def generate_features(model: nn.Module, records, store, batch_size: int, dtype,
                      store_dtype=np.float32, load_images=preprocess_batch,
                      verbose: bool = True) -> int:
    """Features of every record's image into `store` (an object with
    `write(img_id, features)`), through the pipeline; `load_images(paths,
    size)` gives a batch's uint8 NHWC images. Returns the number written."""
    from ..data.prefetch import PrefetchIterator

    size = model.cfg.img_size
    store_dtype = np.dtype(store_dtype)
    t0 = time.time()

    def batches():
        for start in range(0, len(records), batch_size):
            chunk = records[start : start + batch_size]
            imgs = load_images([r["img_path"] for r in chunk], size)
            pad = batch_size - len(chunk)
            if pad:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            yield chunk, imgs

    def drain(pending):
        chunk, feats_dev = pending
        feats = feats_dev.cpu()
        if feats.dtype == torch.bfloat16:  # numpy has no bfloat16: upcast on the host
            feats = feats.float()
        feats = feats.numpy().astype(store_dtype, copy=False)
        for r, f in zip(chunk, feats):
            store.write(r["img_id"], f)
        return len(chunk)

    it = iter(batches())
    prefetch = PrefetchIterator(next_batch=lambda: next(it), materialize=lambda b: b, depth=2)
    done = 0
    pending = None  # (chunk, features still on the device)
    try:
        while True:
            try:
                (chunk, imgs), _ = prefetch.get()
            except StopIteration:
                break
            feats_dev = extract_features(model, imgs, dtype, store_dtype)
            if pending is not None:
                done += drain(pending)
                if verbose and done % (batch_size * 20) == 0:
                    rate = done / max(time.time() - t0, 1e-9)
                    print(f"{done}/{len(records)} ({rate:.1f} img/s)", flush=True)
            pending = (chunk, feats_dev)
        if pending is not None:
            done += drain(pending)
    finally:
        prefetch.close()
    if verbose:
        rate = done / max(time.time() - t0, 1e-9)
        print(f"{done}/{len(records)} ({rate:.1f} img/s)", flush=True)
    return done


def main(argv=None):
    parser = argparse.ArgumentParser(description="Feature generation")
    parser.add_argument("--dataset", choices=["coco", "vizwiz"], default="coco")
    parser.add_argument("--annotations", type=str, required=True)
    parser.add_argument("--images_path", type=str, default="")
    parser.add_argument("--vocab_path", type=str, default=None)
    parser.add_argument("--backbone_checkpoint", type=str, default=None,
                        help=".pth (full model, Swin-official, or backbone-only) or a "
                             "native checkpoint; seeded random weights when omitted")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    parser.add_argument("--swin_img_size", type=int, default=384)
    parser.add_argument("--swin_patch_size", type=int, default=4)
    parser.add_argument("--swin_embed_dim", type=int, default=192)
    parser.add_argument("--swin_depths", type=int, nargs="+", default=[2, 2, 18, 2])
    parser.add_argument("--swin_num_heads", type=int, nargs="+", default=[6, 12, 24, 48])
    parser.add_argument("--swin_window_size", type=int, default=12)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--feature_dtype", choices=["float32", "float16"], default="float32",
                        help="on-disk feature dtype; float16 halves the store "
                             "(the reference's features.hdf5 is 102 GB f32, "
                             "README.md:166-168) and the device->host transfer. "
                             "Readers (data/features_io.py) cast to f32.")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..config import SwinConfig
    from ..data.datasets import load_coco_karpathy, load_vizwiz
    from ..data.features_io import FeatureStore
    from ..data.text import Vocab
    from .demo import resolve_device

    device = resolve_device(args.device)
    vocab = Vocab.from_json(args.vocab_path) if args.vocab_path else None
    if args.dataset == "coco":
        dataset = load_coco_karpathy(args.annotations, args.images_path, vocab=vocab)
    else:
        dataset = load_vizwiz(args.annotations, args.images_path, vocab=vocab)

    swin_cfg = SwinConfig(
        img_size=args.swin_img_size, patch_size=args.swin_patch_size,
        embed_dim=args.swin_embed_dim, depths=tuple(args.swin_depths),
        num_heads=tuple(args.swin_num_heads), window_size=args.swin_window_size,
    )
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.backbone_checkpoint:
        model = _load_backbone(args.backbone_checkpoint, swin_cfg)
    else:
        print("WARNING: random backbone weights (no checkpoint given)", flush=True)
        model = _random_backbone(swin_cfg)
    model.to(device).eval()
    model.prepare_inference(compute_dtype)

    records = [r for s in args.splits for r in dataset.records(s)]
    print(f"extracting features for {len(records)} images", flush=True)
    with FeatureStore(args.output, "w") as store:
        generate_features(model, records, store, args.batch_size, compute_dtype,
                          np.dtype(args.feature_dtype))
    return 0


def _random_backbone(swin_cfg):
    """The backbone with seeded random weights, drawn as `init_weights` draws
    an end-to-end model's backbone."""
    from ..models.end_to_end import init_weights
    from ..models.swin import SwinTransformer

    holder = nn.Module()
    holder.swin_transf = SwinTransformer(swin_cfg)
    init_weights(holder, torch.Generator().manual_seed(0))
    return holder.swin_transf


def _load_backbone(path: str, swin_cfg):
    """A `SwinTransformer` from a full end-to-end state_dict, a Swin-official
    file ({'model': ...}, reference data_generator.py:76-83; its classifier
    head and buffers are not read) or the backbone's own state_dict, each as
    a `.pth` or (but the Swin-official file) a native checkpoint."""
    from ..models.swin import SwinTransformer
    from ..params.convert import clean_reference_state_dict
    from .demo import load_raw

    model = SwinTransformer(swin_cfg)
    sd = load_raw(path)
    if "model" in sd:  # Swin-official pretraining format
        own = model.state_dict()
        sd = {k: v for k, v in sd["model"].items() if k in own}
    else:
        sd = clean_reference_state_dict(sd)
        prefix = "swin_transf."
        if any(k.startswith(prefix) for k in sd):  # the end-to-end model
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    model.load_state_dict(sd, strict=True)
    return model


if __name__ == "__main__":
    raise SystemExit(main())
