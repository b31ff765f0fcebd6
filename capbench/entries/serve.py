"""Batch captioning: a closed loop with one client, back to back.

A request is `batch` uint8 images from the seeded pool: the host-to-card
copy, then the program's `api.Captioner` as its `beam_search` runs it
(`forward_enc`, `decode`, `captions_from_result`), beam `beam`, up to
`max_seq_len` tokens. Its latency runs from submission until the caption
lists are on the host.

The check (`check`): `check_requests` requests, drawn from the seed among
all the window's requests (a reservoir: each kept with the same chance
whatever the window's length), keep their backbone features and encoder
output; the reference recomputes both from the same images and weights,
and scores the served tokens teacher forced (see
`capbench/reference/checks.py`).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import costs, program
from ..reference import checks
from ..traffic import gen


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, tracer, quantize=None,
                 fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.tracer = torch.device(device), tracer
        self.quantize = quantize  # the control: the program's own int8 path
        self.fault = fault  # a planted fault of the checks' own tests
        self.batch = traffic["batch"]

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from on_device_image_captioning_torch.api import Captioner
        from on_device_image_captioning_torch.decode.beam_search import captions_from_result

        t = self.traffic
        self.pool = gen.image_pool(t["pool_images"], self.cfg["swin"]["img_size"], self.seed,
                                   self.device, pin=self.device.type == "cuda")
        mcfg, model, weights = program.build_model(self.cfg, self.seed, self.device)
        self.shapes = [(n, tuple(w.shape)) for n, w in weights.items()]
        del weights
        if self.quantize:
            from on_device_image_captioning_torch.deploy.quantization import quantize_model
            quantize_model(model, self.quantize)
        self._captions_from_result = captions_from_result
        self.captioner = Captioner(
            model, mcfg, {"beam_size": t["beam"], "beam_max_seq_len": t["max_seq_len"],
                          "how_many_outputs": 1},
            device=self.device, step_impl=self.cfg["step_impl"])
        self._features = None
        self._hook = model.swin_transf.register_forward_hook(self._keep_features)
        self._pick = gen.rng(self.seed, "capture")
        self.sample: List[int] = []  # the requests the check reads, one a slot
        self.captured = {}
        for i in range(t["warmup_requests"]):
            self._request(i)

    def _keep_features(self, module, inputs, output) -> None:
        self._features = output

    def _request(self, i: int):
        tr, captions_from_result = self.tracer, self._captions_from_result
        images = gen.pool_batch(self.pool, self.batch, i).to(self.device, non_blocking=True)
        with tr.device_span("encode"):
            cross = self.captioner.forward_enc(images)
        # from the encoder's end on the card until the caption lists are on the host
        with tr.device_span("decode"):
            caps, lps = captions_from_result(self.captioner.decode(cross))
        if self.fault == "altered_token":  # every caption's third token, as produced
            vocab = self.cfg["captioner"]["vocab_size"]
            caps = [[c[:2] + [(c[2] + 1) % vocab] + c[3:] if len(c) > 2 else c for c in row]
                    for row in caps]
        return cross, caps, lps

    def _keep(self, i: int, cross) -> None:
        """Reservoir sampling of the checked requests over the window."""
        k = self.traffic["check_requests"]
        slot = i if i < k else int(self._pick.integers(0, i + 1))
        if slot >= k:
            return
        if slot < len(self.sample):
            del self.captured[self.sample[slot]]
            self.sample[slot] = i
        else:
            self.sample.append(i)
        self.captured[i] = {"cross": cross, "features": self._features}

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        tr = self.tracer
        latencies: List[float] = []
        self.served = []
        start = time.perf_counter()
        end = start + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= end:
                break
            tr.iteration(i, t0 - start, seconds)
            cross, caps, lps = self._request(i)
            latencies.append((time.perf_counter() - t0) * 1e3)
            self.served.append((caps, lps))
            self._keep(i, cross)
            i += 1
        tr.close()
        wall = time.perf_counter() - start
        return {"attempted": i, "failed": 0, "items": i * self.batch, "window_s": wall,
                "iters": i, "latencies_ms": latencies}

    def end_to_end(self, res: Dict) -> Dict[str, tuple]:
        lat = res["latencies_ms"]
        p95 = float(np.percentile(lat, 95)) if lat else float("nan")
        return {"captions_per_s": (res["items"] / res["window_s"], "captions/s"),
                "caption_p95_ms": (p95, "ms")}

    def work(self, first: int, count: int) -> Dict[str, float]:
        """The frozen costs of `count` requests."""
        t = self.traffic
        macs = costs.beam_search_macs(self.cfg, t["beam"], t["max_seq_len"] - 1)["total"]
        bound = costs.bound_s(costs.serve_request_functions(
            self.cfg, self.batch, t["beam"], t["max_seq_len"]))
        return {"items": count * self.batch, "macs": count * self.batch * macs,
                "bound_s": count * bound}

    def release(self) -> None:
        self._hook.remove()
        self.captured = {i: {k: v.float().cpu() for k, v in c.items()}
                         for i, c in self.captured.items()}
        del self.captioner, self._features
        torch.cuda.empty_cache()

    def check(self, diag=None, low=None) -> List[tuple]:
        """low="fp8": the decode numbers are the control's (`checks.serve_numbers`)."""
        missing = self.traffic["check_requests"] - len(self.captured)
        if missing:  # the window finished fewer requests than the check samples
            return [("sampled_requests_missing", float(missing), 0.0)]
        images = {i: gen.pool_batch(self.pool, self.batch, i) for i in sorted(self.captured)}
        return checks.serve_numbers(
            self.cfg, self.shapes, self.seed, self.device, images,
            {i: self.served[i] for i in images}, self.captured, self.traffic["beam"],
            self.traffic["limits"], diag, low)
