"""Captioning demo: image files in, one caption per image out (counterpart of
the JAX package's `cli/demo.py`, reference demo.py).

Loads the Swin-L/384 end-to-end model from a reference `.pth` checkpoint
(its parameter names are this package's), decodes and resizes the images on
the host, and runs beam search on the chosen device:

    python -m on_device_image_captioning_torch.cli.demo --device cuda \
        --load_path rf_model.pth --vocab_path demo_coco_tokens.pickle \
        --image_paths a.jpg b.jpg --beam_size 5

`--device cuda` is the default. Without a CUDA card it raises; it never runs
on the CPU unless `--device cpu` is asked for. `--swin_attention_impl fused`
takes the window-resident backbone path (`config.SwinConfig.attention_impl`);
`--step_impl pallas_fused` takes the decode step that runs the cross-attention
in the step kernel's launch (`decode/cache.py`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle

import torch

from ..config import ATTENTION_IMPLS
from ..decode.cache import STEP_IMPLS


def build_vocab(args):
    from ..data.text import Vocab

    if args.vocab_path and args.vocab_path.endswith(".json"):
        return Vocab.from_json(args.vocab_path)
    if args.vocab_path and args.vocab_path.endswith(".pickle"):
        # reference demo_material/demo_coco_tokens.pickle format
        with open(args.vocab_path, "rb") as f:
            toks = pickle.load(f)
        return Vocab(word2idx=toks["word2idx_dict"])
    raise ValueError("--vocab_path must be a .json vocab or the demo pickle")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but no CUDA card is available")
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Demo")
    parser.add_argument("--model_dim", type=int, default=512)
    parser.add_argument("--N_enc", type=int, default=3)
    parser.add_argument("--N_dec", type=int, default=3)
    parser.add_argument("--max_seq_len", type=int, default=74)
    parser.add_argument("--load_path", type=str, required=True)
    parser.add_argument("--vocab_path", type=str, required=True)
    parser.add_argument("--image_paths", type=str, nargs="+", required=True)
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--swin_attention_impl", choices=ATTENTION_IMPLS, default="pallas")
    parser.add_argument("--step_impl", choices=STEP_IMPLS, default="pallas")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from ..api import Captioner
    from ..config import end_expansionnet_v2_coco
    from ..models.end_to_end import EndExpansionNetV2
    from ..params.convert import load_reference_state_dict
    from ..utils.image import preprocess_batch

    vocab = build_vocab(args)
    cfg = end_expansionnet_v2_coco(
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32
    )
    cfg = dataclasses.replace(
        cfg,
        swin=dataclasses.replace(cfg.swin, attention_impl=args.swin_attention_impl),
        captioner=dataclasses.replace(
            cfg.captioner,
            d_model=args.model_dim,
            N_enc=args.N_enc,
            N_dec=args.N_dec,
            vocab_size=len(vocab),
            max_seq_len=args.max_seq_len,
            sos_idx=vocab.sos_idx,
            eos_idx=vocab.eos_idx,
            pad_idx=vocab.pad_idx,
            unk_idx=vocab.unk_idx,
        ),
    )
    model = EndExpansionNetV2(cfg)
    sd = torch.load(args.load_path, map_location="cpu", weights_only=False)
    load_reference_state_dict(model, sd)
    print("Model loaded ...", flush=True)

    captioner = Captioner(
        model, cfg,
        beam_search_args={
            "beam_size": args.beam_size,
            "how_many_outputs": 1,
            "beam_max_seq_len": args.max_seq_len,
            "sos_idx": vocab.sos_idx,
            "eos_idx": vocab.eos_idx,
        },
        device=device,
        step_impl=args.step_impl,
    )
    images = preprocess_batch(args.image_paths, cfg.swin.img_size)
    caps, _ = captioner.beam_search(images)
    for path, row in zip(args.image_paths, caps):
        print(f"{os.path.basename(path)}: {vocab.description(row[0])}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
