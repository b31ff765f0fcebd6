"""Benchmarking CLI: parameters, analytic FLOPs, latency distribution,
optional pruning rounds and quantized variants, with a plot and a profiler
trace (counterpart of the JAX package's `cli/benchmark.py`; reference
benchmarking/benchmarking.py: FLOPs :24-55, parameter count :58-66, 100-run
latency and matplotlib plots :69-121, pruning rounds :123-151; the quantized
variant in benchmarking/quantized_benchmarking.py).

    python -m on_device_image_captioning_torch.cli.benchmark \
        [--load_path ckpt] [--runs 100] [--batch_size 1] [--beam_size 5] \
        [--prune_rounds 2] [--quantize w8a8] [--plot out.png] [--trace dir]

The model is Swin-L/384 + ExpansionNet v2 (`config.end_expansionnet_v2_coco`,
cut by `--param_config`), seeded random weights unless `--load_path` names a
reference `.pth` or a native checkpoint. The timed call is the path of
`api.Captioner`: uint8 images -> normalization on the device -> encoder ->
beam search (chunked, the decode config's default) -> tokens. One warm-up
call builds the kernels; each timed call ends with the card synchronized.
`--device cuda` is the default and raises without a card; `--device cpu`
runs the plain versions of the kernels (the tests use it on a small
configuration through `run`). Prints one JSON object with the JAX CLI's
keys.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..config import ATTENTION_IMPLS
from ..decode.cache import STEP_IMPLS


def measure_latency(fn, args, runs: int, sync) -> np.ndarray:
    """Seconds of each of `runs` calls of fn(*args), each ended by sync(),
    after one warm-up call (which builds the kernels)."""
    fn(*args)
    sync()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return np.asarray(times)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Benchmarking")
    parser.add_argument("--load_path", type=str, default=None,
                        help="checkpoint; random weights when omitted")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--max_seq_len", type=int, default=20)
    parser.add_argument("--runs", type=int, default=100)
    parser.add_argument("--param_config", type=int, default=0, choices=[0, 1, 2])
    parser.add_argument("--prune_rounds", type=int, default=0)
    parser.add_argument("--prune_amount", type=float, default=0.33)
    parser.add_argument("--quantize", choices=["none", "w8", "w8a8"], default="none")
    parser.add_argument("--plot", type=str, default=None)
    parser.add_argument("--trace", type=str, default=None,
                        help="profile the warm-up and up to 5 runs into this directory "
                             "(torch.profiler, a Chrome trace) before the untraced loop")
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--fp32", dest="bf16", action="store_false")
    parser.add_argument("--swin_attention_impl", choices=ATTENTION_IMPLS, default="fused")
    parser.add_argument("--step_impl", choices=STEP_IMPLS, default="pallas")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def model_config(args: argparse.Namespace):
    """The benchmarked configuration: Swin-L/384 + the d512 captioner in the
    asked dtype and backbone path, cut by --param_config."""
    from ..config import end_expansionnet_v2_coco, remove_layers

    cfg = end_expansionnet_v2_coco(compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    cfg = dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, attention_impl=args.swin_attention_impl))
    return remove_layers(cfg, args.param_config)


def run(args: argparse.Namespace, cfg) -> dict:
    """Benchmark `cfg` as `args` ask; returns the results it prints."""
    from ..config import DecodeConfig
    from ..decode import beam_search as bs
    from ..deploy import analysis
    from ..deploy.pruning import global_l1_prune, sparsity_report
    from ..deploy.quantization import quantize_model
    from ..models.end_to_end import EndExpansionNetV2, init_weights
    from ..params.convert import load_reference_state_dict, w_leaf_names
    from ..utils.image import normalize_on_device
    from .demo import load_params, resolve_device

    device = resolve_device(args.device)
    model = EndExpansionNetV2(cfg)
    if args.load_path:
        load_reference_state_dict(model, load_params(args.load_path))
    else:
        init_weights(model, torch.Generator().manual_seed(0))

    results = {
        "params": analysis.param_count(model),
        "flops": analysis.beam_search_flops(cfg, args.beam_size, args.max_seq_len),
        "flops_reference_strategy": analysis.beam_search_flops(
            cfg, args.beam_size, args.max_seq_len, incremental=False)["total"],
    }

    if args.prune_rounds:
        sd = model.state_dict()
        names = w_leaf_names(model)
        for r in range(args.prune_rounds):
            sd = global_l1_prune(sd, names, args.prune_amount)
            rep = sparsity_report(sd)
            print(f"prune round {r + 1}: global sparsity {rep['GLOBAL']:.3f}", flush=True)
        model.load_state_dict(sd)
        results["global_sparsity"] = sparsity_report(sd)["GLOBAL"]
    if args.quantize != "none":
        quantize_model(model, args.quantize)
        results["quantized"] = args.quantize

    cap = cfg.captioner
    dcfg = DecodeConfig(beam_size=args.beam_size, how_many_outputs=1,
                        max_seq_len=args.max_seq_len, sos_idx=cap.sos_idx, eos_idx=cap.eos_idx)
    # after the counts and the sparsity report: the inference layouts
    model.to(device).eval()
    model.prepare_inference()

    @torch.inference_mode()
    def caption(images_u8):
        enc = model.forward_enc(normalize_on_device(images_u8))
        return bs.beam_search(model, cap, enc, dcfg, dtype=cfg.compute_dtype,
                              step_impl=args.step_impl).tokens

    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (args.batch_size, cfg.swin.img_size, cfg.swin.img_size, 3), dtype=np.uint8)
    ).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if args.trace:
        from ..utils.profiling import trace

        with trace(args.trace):
            measure_latency(caption, (imgs,), min(args.runs, 5), sync)
        print(f"trace written to {args.trace}", flush=True)
    times = measure_latency(caption, (imgs,), args.runs, sync)
    results["latency_s"] = {
        "mean": float(times.mean()), "p50": float(np.percentile(times, 50)),
        "p90": float(np.percentile(times, 90)), "min": float(times.min()),
    }
    results["images_per_sec"] = args.batch_size / float(np.percentile(times, 50))

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 2, figsize=(10, 4))
        ax[0].plot(times * 1e3)
        ax[0].set_xlabel("run")
        ax[0].set_ylabel("latency (ms)")
        ax[0].set_title(
            f"b{args.batch_size} beam{args.beam_size}: "
            f"p50 {results['latency_s']['p50'] * 1e3:.1f} ms"
        )
        ax[1].hist(times * 1e3, bins=30)
        ax[1].set_xlabel("latency (ms)")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        plt.close(fig)
        print(f"plot saved to {args.plot}", flush=True)

    print(json.dumps(results, indent=2), flush=True)
    return results


def main(argv=None):
    args = parse_args(argv)
    run(args, model_config(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
