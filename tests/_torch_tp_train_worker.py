"""Worker of tests/test_torch_tp_train.py (not a test module): one rank of a
tensor-parallel training run of the port on gloo, on the CPU.

    python tests/_torch_tp_train_worker.py <rank> <world> <n_model> <port> <dir> <part>

The rank joins the process group from the environment, makes the (data,
model) grid of `n_model` ranks a model group and runs one part:

- "jax" (2 data x 2 model ranks): two XE steps (PlainRAdam, dropout off) on
  the caption head and on the "pallas" end-to-end model, each cut by
  `shard_model`, each data rank on its rows of the inputs in <dir>; the
  losses, the whole weights and RAdam moments gathered from the group, and
  the rank's replicated (not cut) parameters.
- "port" (one model group of 2): the steps of `CASES` with dropout and
  stochastic depth on, from one generator seed (the test runs them in one
  process too); the round trip of the optimizer state through gather and
  cut; then `cli/train.py --distributed --n_model 2` for an epoch and a
  resume to two, and `cli/evaluate.py --quantize w8 | w8a8 --n_model 2` on
  its checkpoint.

It saves what it got to <dir>/<part>_<rank>.pt. The helpers below build the
models, batches and steps the same way for the test's one-process runs. It
imports no JAX.
"""
import dataclasses
import os
import pathlib
import shutil
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
for path in (REPO, HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import _torch_ddp_worker as ddp  # noqa: E402
from _torch_tp_worker import TP_CAP, TP_E2E, rows  # noqa: E402
from on_device_image_captioning_torch import config as pcfg  # noqa: E402

LR, SEED, N_SAMPLES, SCST_LEN = 1e-2, 7, 2, 6
NO_DROP = pcfg.DropConfig(enc=0.0, dec=0.0, enc_input=0.0, dec_input=0.0, other=0.0)
DROP = pcfg.DropConfig(enc=0.1, dec=0.1, enc_input=0.1, dec_input=0.1, other=0.1)
# the parity with the JAX package: every dropout off (the two packages'
# random streams differ), the "pallas" backbone cut by heads
JAX_CAP = dataclasses.replace(TP_CAP, drop=NO_DROP)
JAX_E2E = dataclasses.replace(
    TP_E2E, swin=dataclasses.replace(TP_E2E.swin, drop_path_rate=0.0),
    captioner=dataclasses.replace(TP_E2E.captioner, drop=NO_DROP))
# the parity with one process of the port: every dropout of the caption
# head, Swin's dropout on its MLP and attention probabilities, and
# stochastic depth, at 0.1
DROP_CAP = dataclasses.replace(TP_CAP, drop=DROP)
DROP_E2E = dataclasses.replace(
    TP_E2E, swin=dataclasses.replace(TP_E2E.swin, drop_path_rate=0.1, drop_rate=0.1,
                                     attn_drop_rate=0.1),
    captioner=dataclasses.replace(TP_E2E.captioner, drop=DROP))
# "fused": Swin whole on every rank, on the training kernels' plain versions
# (its drop_rate and attn_drop_rate 0: the kernels' condition)
FUSED_E2E = dataclasses.replace(
    DROP_E2E, swin=dataclasses.replace(TP_E2E.swin, drop_path_rate=0.1,
                                       attention_impl="fused"))
# case -> (config, steps, --num_accum, remat, kind)
CASES = {
    "cap": (DROP_CAP, 2, 1, False, "xe"),
    "cap_accum2": (DROP_CAP, 3, 2, False, "xe"),
    "pallas": (DROP_E2E, 2, 1, False, "xe"),
    "pallas_remat": (DROP_E2E, 2, 1, True, "xe"),
    "fused": (FUSED_E2E, 2, 1, False, "xe"),
    "scst": (DROP_CAP, 1, 1, False, "scst"),
    "scst_fused": (DROP_CAP, 1, 1, False, "scst_fused"),
}
JAX_CASES = {"cap": JAX_CAP, "pallas": JAX_E2E}



def make_model(cfg, root):
    """The caption head (a CaptionerConfig) or the end-to-end model (a
    ModelConfig) with the weights the test wrote to <root>, training."""
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
    from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2

    if isinstance(cfg, pcfg.CaptionerConfig):
        model = ExpansionNetV2(cfg)
        model.load_state_dict(torch.load(root / "cap.pt"))
    else:
        model = EndExpansionNetV2(cfg)
        model.load_state_dict(torch.load(root / "e2e.pt"))
    return model.train()


def batches(cfg, root, steps, sl=slice(None)):
    """`steps` XE batches (rows `sl` of each) from the arrays in <root>, in
    turn."""
    caps = torch.from_numpy(np.load(root / "captions.npy")).long()
    n = caps.shape[0]
    if isinstance(cfg, pcfg.CaptionerConfig):
        feats = torch.from_numpy(np.load(root / "feats.npy"))
        pads = torch.from_numpy(np.load(root / "pads.npy"))
        return [{"enc_input": feats[i % n][sl], "enc_num_pads": pads[i % n][sl],
                 "captions": caps[i % n][sl]} for i in range(steps)]
    imgs = torch.from_numpy(np.load(root / "imgs.npy"))
    return [{"enc_input": imgs[i % n][sl], "captions": caps[i % n][sl]} for i in range(steps)]


def reward_fn(tokens, lengths, tables=None):
    """A reward that is an integer function of the sampled tokens (exact on
    every rank): their sum modulo 7 over 7, per sample."""
    keep = torch.arange(tokens.shape[-1]) < (lengths[..., None] + 1)
    return ((tokens.long() * keep).sum(-1) % 7).float() / 7


def run_case(net, model, case, root, sl=slice(None), cfg=None):
    """Case `case` of CASES on `net` (the model, or its DataParallel), on
    rows `sl` of the batches, with `cfg` in place of the case's config where
    given: {"loss": [per step], "tokens": the SCST samples, "opt": the
    optimizer}."""
    from on_device_image_captioning_torch.decode import sampling
    from on_device_image_captioning_torch.train import train_step
    from on_device_image_captioning_torch.train.radam import PlainRAdam

    case_cfg, steps, accum, remat, kind = CASES[case]
    cfg = cfg or case_cfg
    opt = train_step.with_grad_accum(PlainRAdam(model.parameters(), LR), accum)
    gen = torch.Generator().manual_seed(SEED)
    out = {"loss": [], "tokens": None, "opt": opt}
    cap_cfg = cfg.captioner if hasattr(cfg, "captioner") else cfg
    if kind == "xe":
        step = train_step.make_xe_step(net, cfg, opt, remat=remat)
        for batch in batches(cfg, root, steps, sl):
            out["loss"].append(float(step(batch, gen)["loss"]))
        return out
    batch = batches(cfg, root, 1, sl)[0]
    batch.pop("captions")
    if kind == "scst":
        with torch.no_grad():
            enc = model.forward_enc(batch["enc_input"], batch["enc_num_pads"])
            sampled = sampling.sample(model, cap_cfg, enc, N_SAMPLES, SCST_LEN, cap_cfg.sos_idx,
                                      cap_cfg.eos_idx, enc_num_pads=batch["enc_num_pads"],
                                      generator=gen)
        step = train_step.make_scst_step(net, cfg, opt, N_SAMPLES)
        metrics = step(batch, {"tokens": sampled.tokens, "lengths": sampled.lengths},
                       reward_fn(sampled.tokens, sampled.lengths), gen)
        out["tokens"] = sampled.tokens
    else:
        step = train_step.make_scst_fused_step(net, cfg, opt, N_SAMPLES, SCST_LEN,
                                               cap_cfg.sos_idx, cap_cfg.eos_idx, reward_fn,
                                               dropout=True)
        metrics = step(batch, None, gen)
        out["tokens"] = metrics["sampled"].tokens
    out["loss"].append(float(metrics["loss"]))
    return out


def cli_flags(root):
    """The training CLI's flags on the corpus of tests/_torch_ddp_worker.py
    (every dropout 0: a resume restarts the generator), the eval hook at the
    end of each epoch."""
    return ["--annotations", str(root / "ann.json"), "--features_path", str(root / "f.hdf5"),
            *ddp.CLI_FLAGS, "--eval_every_iter", "6", "--eval_beam_sizes", "2",
            "--eval_parallel_batch_size", "2"]


def eval_flags(root, ckpt_path, scheme, dump):
    return ["--annotations", str(root / "ann.json"), "--features_path", str(root / "f.hdf5"),
            "--load_path", str(ckpt_path), "--split", "val", "--beam_sizes", "2",
            "--batch_size", "2", "--max_seq_len", "12", "--model_dim", "32", "--N_enc", "1",
            "--N_dec", "1", "--ff", "64", "--num_heads", "4", "--num_exp_enc_list", "4",
            "--num_exp_dec", "4", "--img_feature_dim", str(ddp.FEAT_DIM), "--quantize", scheme,
            "--metrics", "bleu", "--dump_predictions", str(dump), "--device", "cpu"]


def checkpoint_path(save):
    from on_device_image_captioning_torch.utils import checkpointing as ckpt

    names = [f for f in os.listdir(save) if ckpt._NAME.match(f)]
    assert len(names) == 1, names
    return pathlib.Path(save) / names[0]


def named_state(opt_state, model):
    """{parameter name: {"mu", "nu"}} of a PlainRAdam state_dict."""
    names = [n for n, _ in model.named_parameters()]
    return {names[i]: st for i, st in opt_state["state"].items()}


def main(rank, world, n_model, port, root, part):
    from on_device_image_captioning_torch.cli import evaluate as eval_cli
    from on_device_image_captioning_torch.cli import train as cli
    from on_device_image_captioning_torch.parallel import mesh as pm

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    device = pm.init_distributed(torch.device("cpu"))
    grid = pm.make_grid(n_model)
    out = {"grid": (grid.n_data, grid.n_model, grid.data_rank, grid.model_rank)}

    def cut(model):
        lines = pm.shard_model(model, grid)
        net = pm.DataParallel(model, device, grid.data_group) if grid.n_data > 1 else model
        return net, lines

    def results(model, got):
        return {"loss": got["loss"], "tokens": got["tokens"],
                "whole": pm.gather_state_dict(model, grid),
                "opt": pm.gather_optimizer_state(got["opt"].state_dict(), model, grid),
                "own": {k: v.clone() for k, v in model.state_dict().items()
                        if k not in model.model_axis_cuts}}

    if part == "jax":
        for name, cfg in JAX_CASES.items():
            model = make_model(cfg, root)
            net, _ = cut(model)
            got = run_case(net, model, name, root, rows(8, grid), cfg)
            out[name] = results(model, got)
            out[name]["opt"] = named_state(out[name]["opt"], model)
    else:
        for name, (cfg, *_) in CASES.items():
            model = make_model(cfg, root)
            net, lines = cut(model)
            got = run_case(net, model, name, root)
            out[name] = results(model, got)
            if name == "cap":
                out["lines"] = lines
                # the round trip: the whole state cut again is the rank's, bit for bit
                out["round_trip"] = (got["opt"].state_dict(),
                                     pm.cut_optimizer_state(out[name]["opt"], model))
        # the CLI: an epoch at --n_model 2, a checkpoint, a resume to two
        saves = root / "tp_saves"
        assert cli.main([*cli_flags(root), "--save_path", str(saves) + "/", "--distributed",
                         "--n_model", str(n_model), "--metrics_jsonl",
                         str(root / f"tp1_{rank}.jsonl")]) == 0
        pm.barrier()
        if rank == 0:
            shutil.copytree(saves, root / "tp_resume")
            shutil.copytree(saves, root / "one_resume")  # the test resumes it in one process
        pm.barrier()
        assert cli.main([*cli_flags(root), "--save_path", str(root / "tp_resume") + "/",
                         "--num_epochs", "2", "--distributed", "--n_model", str(n_model),
                         "--metrics_jsonl", str(root / f"tp2_{rank}.jsonl")]) == 0
        for scheme in ("w8", "w8a8"):
            assert eval_cli.main(eval_flags(root, checkpoint_path(saves), scheme,
                                            root / f"tp_{scheme}.json")
                                 + ["--distributed", "--n_model", str(n_model)]) == 0
    torch.save(out, root / f"{part}_{rank}.pt")
    pm.shutdown()
    print(f"WORKER {rank} done", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         pathlib.Path(sys.argv[5]), sys.argv[6])
