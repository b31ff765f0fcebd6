"""Worker of tests/test_torch_tensor_parallel.py (not a test module): one rank
of a tensor-parallel run of the port on gloo, on the CPU.

    python tests/_torch_tp_worker.py <rank> <world> <n_model> <port> <dir>

The rank joins the process group from the environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT), makes the (data, model) grid of `n_model` ranks a
model group, takes its data rank's rows of the inputs in <dir> (written by the
test with numpy, beside the weights as port state_dicts) and, on models cut by
`parallel/mesh.py::shard_model`: the features-in forward's log-probs, beam
search on both decode-step paths, and the "pallas" end-to-end encode. It
saves them to <dir>/out<world>_<rank>.pt. It imports no JAX: the test holds
the results to the JAX package.
"""
import dataclasses
import os
import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from on_device_image_captioning_torch import config as pcfg  # noqa: E402

# tests/test_parallel.py's TINY captioner, and an end-to-end config whose
# Swin heads (2, 4), widths and vocabulary 2 divides
TP_CAP = pcfg.CaptionerConfig(
    d_model=32, N_enc=2, N_dec=2, ff=64, num_heads=4, num_exp_enc_list=(4, 8),
    num_exp_dec=4, vocab_size=48, max_seq_len=16, img_feature_dim=24,
    sos_idx=2, eos_idx=3, pad_idx=0, unk_idx=1)
TP_E2E = pcfg.ModelConfig(
    swin=pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                         num_heads=(2, 4), window_size=4, attention_impl="pallas"),
    captioner=dataclasses.replace(TP_CAP, vocab_size=64, img_feature_dim=32))
BEAM, MAX_LEN = 3, 12
STEP_IMPLS = ("pallas", "pallas_fused")


def rows(n: int, grid) -> slice:
    per = n // grid.n_data
    return slice(grid.data_rank * per, (grid.data_rank + 1) * per)


def main(rank: int, world: int, n_model: int, port: int, root: pathlib.Path) -> None:
    from on_device_image_captioning_torch.config import DecodeConfig
    from on_device_image_captioning_torch.decode.beam_search import beam_search
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
    from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
    from on_device_image_captioning_torch.parallel import mesh as pm
    from on_device_image_captioning_torch.utils.image import normalize_on_device

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    pm.init_distributed(torch.device("cpu"))
    grid = pm.make_grid(n_model)
    out = {"grid": (grid.n_data, grid.n_model, grid.data_rank, grid.model_rank)}

    model = ExpansionNetV2(TP_CAP)
    model.load_state_dict(torch.load(root / "cap.pt"))
    out["lines"] = pm.shard_model(model, grid)
    model.eval()
    sl = rows(8, grid)
    feats = torch.from_numpy(np.load(root / "feats.npy"))[sl]
    toks = torch.from_numpy(np.load(root / "toks.npy"))[sl]
    pads = torch.from_numpy(np.load(root / "pads.npy"))[sl]
    dcfg = DecodeConfig(beam_size=BEAM, how_many_outputs=1, max_seq_len=MAX_LEN,
                        sos_idx=TP_CAP.sos_idx, eos_idx=TP_CAP.eos_idx)
    with torch.no_grad():
        out["forward"] = model(feats, toks, apply_log_softmax=True)
        enc = model.forward_enc(feats, pads)
        for impl in STEP_IMPLS:
            res = beam_search(model, TP_CAP, enc, dcfg, enc_num_pads=pads, step_impl=impl)
            out["beam_" + impl] = (res.tokens, res.lengths, res.logprobs)

    e2e = EndExpansionNetV2(TP_E2E)
    e2e.load_state_dict(torch.load(root / "e2e.pt"))
    out["e2e_lines"] = pm.shard_model(e2e, grid)
    e2e.eval().prepare_inference()
    imgs = torch.from_numpy(np.load(root / "imgs.npy"))[rows(4, grid)]
    with torch.no_grad():
        out["encode"] = e2e.forward_enc(normalize_on_device(imgs))
    torch.save(out, root / f"out{world}_{rank}.pt")
    pm.shutdown()
    print(f"WORKER {rank} done", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         pathlib.Path(sys.argv[5]))
