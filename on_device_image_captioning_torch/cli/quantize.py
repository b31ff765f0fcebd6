"""Quantization CLI (counterpart of the JAX package's `cli/quantize.py`,
reference quantization.py): quantize a checkpoint's encoder and/or decoder
half to int8, save the quantized model's state_dict, and caption demo images
with it for a visual check.

    python -m on_device_image_captioning_torch.cli.quantize \
        --load_path rf_model.pth --vocab_path vocab.json --output q_model.pth \
        --scheme w8a8 --halves encoder decoder [--image_paths demo.jpg] [--device cuda]

`--load_path` takes a reference `.pth` or a native checkpoint
(`cli/demo.py::load_params`).

`--device cuda` is the default and raises without a CUDA card; quantization
itself runs where the checkpoint is loaded (the CPU), the demo captions on the
device. The saved file loads back with `params/convert.py::
load_reference_state_dict` (which `cli/demo.py` uses) into an
`EndExpansionNetV2` of the same configuration.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Sequence, Tuple

import torch
from torch import nn

HALVES = ("encoder", "decoder")


def quantize_halves(model: nn.Module, scheme: str, halves: Sequence[str]) -> Tuple[int, int]:
    """Quantize the named halves of `model` in place; returns the parameter
    bytes before and after."""
    from ..deploy.quantization import quantize_decoder, quantize_encoder, quantized_size_bytes

    before = quantized_size_bytes(model)
    if "encoder" in halves:
        quantize_encoder(model, scheme)
    if "decoder" in halves:
        quantize_decoder(model, scheme)
    return before, quantized_size_bytes(model)


def size_line(scheme: str, halves: Sequence[str], before: int, after: int) -> str:
    return f"quantized ({scheme}, halves={list(halves)}): {before / 1e6:.1f} MB -> {after / 1e6:.1f} MB"


def main(argv=None):
    parser = argparse.ArgumentParser(description="Quantization")
    parser.add_argument("--load_path", type=str, required=True)
    parser.add_argument("--vocab_path", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--scheme", choices=["w8", "w8a8"], default="w8")
    parser.add_argument("--halves", nargs="+", default=list(HALVES), choices=HALVES)
    parser.add_argument("--image_paths", type=str, nargs="*", default=[])
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--max_seq_len", type=int, default=74)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from .demo import build_vocab, load_params, resolve_device

    device = resolve_device(args.device)
    from ..api import Captioner
    from ..config import end_expansionnet_v2_coco
    from ..models.end_to_end import EndExpansionNetV2
    from ..params.convert import load_reference_state_dict
    from ..utils.image import preprocess_batch

    vocab = build_vocab(args)
    cfg = end_expansionnet_v2_coco()
    cfg = dataclasses.replace(
        cfg,
        captioner=dataclasses.replace(
            cfg.captioner, vocab_size=len(vocab), max_seq_len=args.max_seq_len,
            sos_idx=vocab.sos_idx, eos_idx=vocab.eos_idx, pad_idx=vocab.pad_idx,
            unk_idx=vocab.unk_idx,
        ),
    )
    model = EndExpansionNetV2(cfg)
    load_reference_state_dict(model, load_params(args.load_path))
    before, after = quantize_halves(model, args.scheme, args.halves)
    print(size_line(args.scheme, args.halves, before, after), flush=True)
    torch.save(model.state_dict(), args.output)
    print(f"saved {args.output}", flush=True)

    if args.image_paths:
        captioner = Captioner(
            model, cfg,
            {"beam_size": args.beam_size, "how_many_outputs": 1,
             "beam_max_seq_len": args.max_seq_len},
            device=device,
        )
        caps, _ = captioner.beam_search(preprocess_batch(args.image_paths, cfg.swin.img_size))
        for path, row in zip(args.image_paths, caps):
            print(f"{os.path.basename(path)}: {vocab.description(row[0])}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
