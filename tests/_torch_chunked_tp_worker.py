"""Worker of tests/test_torch_chunked_decode.py (not a test module): one rank
of a two-rank model group on gloo, on the CPU, decoding in phases.

    python tests/_torch_chunked_tp_worker.py <rank> <port> <dir>

The rank joins a world of two from the environment it sets (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), cuts the caption head of
<dir>/cap.pt over one model group of both ranks (`parallel/mesh.py::
shard_model`) and runs beam search over the features in <dir>/feats.npy
with the chunk schedules CHUNKS, on both decode-step paths, noting the
shape of every cache after each growth. It saves the results to
<dir>/out<rank>.pt.
"""
import os
import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
for path in (REPO, REPO / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from _torch_tp_worker import BEAM, STEP_IMPLS, TP_CAP  # noqa: E402

L = TP_CAP.max_seq_len
CHUNKS = ((4, 8, L), (L,))


def main(rank: int, port: int, root: pathlib.Path) -> None:
    from on_device_image_captioning_torch.config import DecodeConfig
    from on_device_image_captioning_torch.decode import beam_search as bs
    from on_device_image_captioning_torch.decode import cache as dc
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
    from on_device_image_captioning_torch.parallel import mesh as pm

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    pm.init_distributed(torch.device("cpu"))
    grid = pm.make_grid(2)
    model = ExpansionNetV2(TP_CAP)
    model.load_state_dict(torch.load(root / "cap.pt"))
    pm.shard_model(model, grid)
    model.eval()
    grown = []
    real_grow = dc.grow_state

    def grow_state(state, new_len):
        out = real_grow(state, new_len)
        if out is not state:
            grown.append([tuple(t.shape) for layer in out.caches for t in layer])
        return out

    dc.grow_state = grow_state
    out = {"grown": grown}
    with torch.no_grad():
        enc = model.forward_enc(torch.from_numpy(np.load(root / "feats.npy")))
        for chunks in CHUNKS:
            dcfg = DecodeConfig(beam_size=BEAM, how_many_outputs=BEAM, max_seq_len=L,
                                sos_idx=TP_CAP.sos_idx, eos_idx=TP_CAP.eos_idx,
                                chunk_schedule=chunks)
            for impl in STEP_IMPLS:
                res = bs.beam_search(model, TP_CAP, enc, dcfg, step_impl=impl)
                out[(chunks, impl)] = bs.captions_from_result(res)
    torch.save(out, root / f"out{rank}.pt")
    pm.shutdown()
    print(f"WORKER {rank} done", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
