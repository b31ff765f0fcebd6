"""Worker of tests/test_torch_parallel_eval.py (not a test module): one rank of
a two-process data-parallel (and tensor-parallel) evaluation on gloo, on the
CPU.

    python tests/_torch_eval_worker.py <rank> <port> <dir>

The rank joins a gloo group itself (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), then calls, in the order of <dir>/runs.json, `cli/evaluate.py`'s
`main` with each run's arguments and `--distributed` (the CLI keeps the group
it finds), its output to <dir>/<run>.<rank>.out; then
`compute_evaluation_loss` over the grid of one model rank on the features-in
head of <dir>/head.pth, to <dir>/loss.<rank>.json; then `cli/train.py
--distributed` with the arguments of <dir>/train.json, its eval hook spied on:
what each of its `evaluate_split` calls returned on this rank, to
<dir>/train.<rank>.json (its output to <dir>/train.<rank>.out).
"""
import contextlib
import json
import os
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main(rank: int, port: int, root: pathlib.Path) -> None:
    from on_device_image_captioning_torch.cli import evaluate as eval_cli
    from on_device_image_captioning_torch.cli import train as train_cli
    from on_device_image_captioning_torch.config import CaptionerConfig
    from on_device_image_captioning_torch.data.datasets import load_coco_karpathy
    from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
    from on_device_image_captioning_torch.parallel import mesh as pm

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    pm.init_distributed(torch.device("cpu"))
    for name, argv in json.loads((root / "runs.json").read_text()):
        with open(root / f"{name}.{rank}.out", "w") as f, contextlib.redirect_stdout(f):
            assert eval_cli.main([*argv, "--distributed", "--device", "cpu"]) == 0
        assert pm.is_distributed()

    spec = json.loads((root / "loss.json").read_text())
    model = ExpansionNetV2(CaptionerConfig(**spec["cfg"]))
    model.load_state_dict(torch.load(root / "head.pth"))
    loss = eval_cli.compute_evaluation_loss(
        model.eval(), model.cap_cfg, load_coco_karpathy(spec["annotations"]), "test",
        spec["batch_size"], spec["features"], grid=pm.make_grid(1))
    (root / f"loss.{rank}.json").write_text(json.dumps(loss))

    calls = []
    split = eval_cli.evaluate_split

    def spied(*args, **kwargs):
        scores, preds = split(*args, **kwargs)
        grid = kwargs["grid"]
        calls.append({"grid": [grid.n_data, grid.data_rank], "scores": scores,
                      "predictions": {str(k): v for k, v in preds.items()}})
        return scores, preds

    eval_cli.evaluate_split = spied
    with open(root / f"train.{rank}.out", "w") as f, contextlib.redirect_stdout(f):
        assert train_cli.main([*json.loads((root / "train.json").read_text()),
                               "--distributed", "--device", "cpu"]) == 0
    (root / f"train.{rank}.json").write_text(json.dumps(calls))
    print(f"WORKER {rank} done", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
