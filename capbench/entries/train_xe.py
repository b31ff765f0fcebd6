"""End-to-end cross-entropy training: a closed loop of the program's
`train/train_step.py::make_xe_step` step over the whole model.

Every step takes `batch` pool images and one caption each (lengths fixed by
the traffic file, padded to the batch's longest), staged from pinned host
memory to the card inside the window, dropout drawn from one generator on
the card seeded from the seed. The optimizer is the program's RAdam with the
recipe's schedule, resumed at the configuration's count.

Set-up builds the one training object and drives it through its first
`checked_steps` steps, which the check follows: it keeps their losses, the
first step's backbone features (a forward hook on the backbone), the first
step's gradient as the optimizer got it (from RAdam's first moment after
one step: mu = (1 - b1) g), the parameters after that step, and the
parameters' change after all of them. Further set-up steps warm every
padded length the traffic has; then the window continues the same object.

Once the window has closed (and the memory peak has been read), the same
object takes `late_steps` more steps through the window's own call and
feed, from the state the window left: the check follows those too, from a
copy of that state (parameters, moments, count, the dropout generator's).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .. import costs, program
from ..reference import checks
from ..traffic import gen
from ..weights import draw_weights


def _state(opt, named) -> Dict:
    """RAdam's state as the reference takes it: {"mu", "nu": {leaf: moment},
    "count"} (zero moments where a leaf has none yet)."""
    out = {"mu": {}, "nu": {}, "count": opt.count}
    for n, p in named:
        st = opt.state[p]
        for k in ("mu", "nu"):
            out[k][n] = st[k].clone() if k in st else torch.zeros_like(p)
    return out


def _grads(opt, named, mu0: Optional[Dict], b1: float, to) -> Dict[str, torch.Tensor]:
    """The gradient of the step just taken as the optimizer got it, on the
    device `to`: mu = b1 mu0 + (1 - b1) g (mu0 None: empty moments)."""
    out = {}
    for n, p in named:
        mu = opt.state[p].get("mu")
        mu = torch.zeros_like(p) if mu is None else mu
        out[n] = ((mu if mu0 is None else mu - b1 * mu0[n]) / (1 - b1)).to(to)
    return out


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, tracer, fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.tracer = torch.device(device), tracer
        self.fault = fault  # a planted fault of the checks' own tests
        self.batch = traffic["batch"]

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            int(gen.rng(self.seed, "dropout").integers(0, 2**62)))

    def setup(self) -> None:
        from on_device_image_captioning_torch.train import schedules
        from on_device_image_captioning_torch.train.radam import RAdam
        from on_device_image_captioning_torch.train.train_step import make_xe_step

        t, c = self.traffic, self.cfg["optimizer"]
        self.inputs()
        mcfg, model, weights = program.build_model(self.cfg, self.seed, self.device)
        self.shapes = [(n, tuple(w.shape)) for n, w in weights.items()]
        del weights
        model.train()
        sched = schedules.custom_warmup_anneal(c["lr"], c["warmup_iters"], c["min_lr"],
                                               c["anneal_coeff"], c["anneal_every_epoch"],
                                               c["num_batches"])
        opt = RAdam(model.parameters(), sched, b1=c["b1"], b2=c["b2"], eps=c["eps"])
        state = opt.state_dict()
        state["count"] = c["resume_count"]
        opt.load_state_dict(state)
        self.model, self.opt = model, opt
        self.step = make_xe_step(model, mcfg, opt, smoothing=self.cfg["label_smoothing"])
        self.generator = self._generator()
        self.named = list(model.named_parameters())

        self.checked = {"loss": [], "grad": {}, "update": {}, "features": None}
        hook = model.swin_transf.register_forward_hook(self._keep_features)
        for i in range(t["checked_steps"]):
            out = self._step(i)
            hook.remove()
            self.checked["loss"].append(float(out["loss"]))
            if i == 0:  # kept on the host, out of the program's memory peak
                self._keep_step(self.checked, None, torch.device("cpu"))
        with torch.no_grad():
            p0 = draw_weights(self.shapes, self.seed, self.device)
            self.checked["update"] = {n: float((p - p0[n]).norm()) for n, p in self.named}
            del p0
        # one step at every padded length the checked steps did not run
        seen = {self.captions[i].shape[1] for i in range(t["checked_steps"])}
        for i, x in enumerate(self.captions):
            if x.shape[1] not in seen:
                seen.add(x.shape[1])
                self._step(i)
        self.cursor = t["checked_steps"]
        self.window_steps, self.late = 0, None

    @torch.no_grad()
    def _keep_step(self, into: Dict, mu0: Optional[Dict], to) -> None:
        """The step just taken: its gradient as the optimizer got it (the
        tensors and their norms) and the parameters after it, on `to`."""
        into["grads"] = _grads(self.opt, self.named, mu0, self.cfg["optimizer"]["b1"], to)
        into["grad"] = {n: float(g.norm()) for n, g in into["grads"].items()}
        into["after"] = {n: p.detach().to(to, copy=True) for n, p in self.named}

    def _late(self) -> None:
        """After the window: a copy of the state it left, then `late_steps`
        steps of the same object through the window's call and feed."""
        first = self.cursor + self.window_steps
        late = {"first": first, "loss": [], "state": _state(self.opt, self.named),
                "before": {n: p.detach().clone() for n, p in self.named},
                "generator": self.generator.get_state()}
        for j in range(self.traffic["late_steps"]):
            out = self._step(first + j)
            late["loss"].append(float(out["loss"]))
            if j == 0:
                self._keep_step(late, late["state"]["mu"], self.device)
        self.late = late

    def inputs(self) -> None:
        """The seed's image pool and caption batches, on the host (pinned
        where the card is)."""
        pin = self.device.type == "cuda"
        self.pool = gen.image_pool(self.traffic["pool_images"], self.cfg["swin"]["img_size"],
                                   self.seed, self.device, pin=pin)
        caps = gen.caption_batches(self.traffic, self.cfg["captioner"], self.seed)
        self.captions = [x.pin_memory() if pin else x for x in caps]

    def reference_steps(self, precision: str = "fp32") -> Dict:
        """The reference's own run of the set-up's checked steps from the
        seed's weights (`checks.train_reference`)."""
        batches = [self._batch(i) for i in range(self.traffic["checked_steps"])]
        p0 = draw_weights(self.shapes, self.seed, self.device)
        return checks.train_reference(self.cfg, p0, self.device, batches, self._generator(),
                                      precision)

    def _keep_features(self, module, inputs, output) -> None:
        """The first checked step's backbone features (its training forward)."""
        self.checked["features"] = output.detach().float().cpu()

    def _batch(self, i: int) -> Dict[str, torch.Tensor]:
        images = gen.pool_batch(self.pool, self.batch, i)
        caps = self.captions[i % len(self.captions)]
        return {"images": images, "captions": caps}

    def _step(self, i: int):
        b = self._batch(i)
        batch = {"enc_input": b["images"].to(self.device, non_blocking=True),
                 "captions": b["captions"].to(self.device, non_blocking=True)}
        if self.fault == "half_batch":  # the forward at full size, the loss over half
            caps = batch["captions"].clone()
            caps[self.batch // 2:, 1:] = self.cfg["captioner"]["pad_idx"]
            batch["captions"] = caps
        if self.fault == "unchanged":  # the step leaves model and optimizer as they were
            return {"loss": torch.zeros((), device=self.device)}
        with self.tracer.span("step"):
            return self.step(batch, generator=self.generator)

    def window(self, seconds: float) -> Dict:
        tr = self.tracer
        start = time.perf_counter()
        end = start + seconds
        n = 0
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            tr.iteration(n, now - start, seconds)
            self._step(self.cursor + n)
            n += 1
        tr.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
        self.window_steps = n
        return {"attempted": n, "failed": 0, "items": n * self.batch, "window_s": wall,
                "iters": n}

    def end_to_end(self, res: Dict) -> Dict[str, tuple]:
        return {"train_images_per_s": (res["items"] / res["window_s"], "images/s")}

    def work(self, first: int, count: int) -> Dict[str, float]:
        """The frozen costs of the window's steps first ... first + count - 1
        (the padded length moves the decoder's share)."""
        lengths = [self.captions[(self.cursor + i) % len(self.captions)].shape[1] - 1
                   for i in range(first, first + count)]
        return {"items": count * self.batch,
                "macs": self.batch * sum(costs.xe_step_macs(self.cfg, t)["total"]
                                         for t in lengths),
                "bound_s": sum(costs.bound_s(costs.xe_step_functions(self.cfg, self.batch, t))
                               for t in lengths)}

    def release(self) -> None:
        if self.traffic["late_steps"]:
            self._late()
        del self.step, self.opt, self.model, self.named
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, diag=None) -> List[tuple]:
        c, limits = self.checked, self.traffic["limits"]
        p0 = draw_weights(self.shapes, self.seed, self.device)
        grads = {n: g.to(self.device) for n, g in c.pop("grads").items()}
        opt = checks.optimizer_gaps(self.cfg, p0, None, grads, c.pop("after"))
        del grads
        del p0
        numbers = checks.train_numbers(c, self.reference_steps(), limits, diag, opt)
        late = self.late
        if late is not None:
            opt = checks.optimizer_gaps(self.cfg, late["before"], late["state"],
                                        late.pop("grads"), late.pop("after"))
            g = torch.Generator(device=self.device)
            g.set_state(late["generator"])
            batches = [self._batch(late["first"] + j) for j in range(len(late["loss"]))]
            ref = checks.train_reference(self.cfg, late["before"], self.device, batches, g,
                                         "fp32", late["state"])
            numbers += checks.train_numbers(late, ref, limits, diag, opt, ".late")
        return numbers
