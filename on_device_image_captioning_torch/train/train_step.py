"""Training steps: cross-entropy (XE) teacher forcing and the SCST gradient
(counterpart of the JAX package's `train/train_step.py`).

XE: model(enc_x, dec_x = y[:, :-1]) against the targets y[:, 1:] under the
label-smoothing loss, gradients of every parameter, one optimizer update
(reference train.py:107-123). Gradient accumulation applies the optimizer
every `num_accum` micro-steps on the mean of their gradients
(train.py:174-176; `optax.MultiSteps` in the JAX package).

SCST: sample N captions per image, CIDEr reward with the leave-one-out mean
baseline, loss = mean of (r - b) * sum(-logp) (train.py:124-172,
losses/reward.py). The gradient pass re-scores the sampled captions teacher
forced (the sampling pass's log-probs, differentiable without going back
through the decode loop).

Every step works for both models: `EndExpansionNetV2` with a `ModelConfig`
(batch "enc_input": images NHWC, uint8 or normalized floats) and the caption
head `ExpansionNetV2` with a `CaptionerConfig` (batch "enc_input": features
(B, S, img_feature_dim), and "enc_num_pads" (B,) where rows are padded).

Data parallel: every step also takes the model wrapped in
`parallel/mesh.py::DataParallel` (each data rank with its own rows of the
batch); a bare model runs as its one-process stand-in `Local`, through the
same code. The step's differentiable part runs as one (DDP) forward, the XE
loss is normalized by the non-pad tokens of all data ranks (that module's
docstring says why), and the returned metrics are means over the data ranks.

Tensor parallel: the model may be cut over a model axis
(`parallel/mesh.py::shard_model`); its collectives are autograd functions
(`parallel/tensor.py`), so the steps run unchanged. The ranks of a model
group read the same rows and hold the same generator, so they draw the same
dropout masks (whole masks, `models/common.py::dropout`), the same sampler
noise over whole logit rows, the same samples and the same rewards;
`DataParallel` spans the data group only.

`remat=True` recomputes each Swin block off the training kernels in the
backward (`models/swin.py`), as the JAX steps' `remat` does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import CaptionerConfig, ModelConfig
from ..decode import sampling
from ..parallel.mesh import replicated
from ..utils.image import normalize_on_device
from ..utils.profiling import span
from .losses import label_smoothing_loss, mean_baseline, scst_loss


def _caption_cfg(cfg) -> CaptionerConfig:
    return cfg.captioner if isinstance(cfg, ModelConfig) else cfg


def _images(batch) -> torch.Tensor:
    images = batch["enc_input"]
    return normalize_on_device(images) if images.dtype == torch.uint8 else images


def _encode(model, cfg, batch, generator, remat=False):
    """The training (train=True) encoder forward of either model: (encoder
    output, its pad counts or None, the decoder's compute dtype). `cfg` is a
    ModelConfig for the end-to-end model, a CaptionerConfig for the caption
    head."""
    if isinstance(cfg, ModelConfig):
        return (model.forward_enc(_images(batch), True, generator, None, remat), None,
                cfg.compute_dtype)
    pads = batch.get("enc_num_pads")
    return model.forward_enc(batch["enc_input"], pads, None, True, generator), pads, None


def xe_loss(model, cfg, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, smoothing: float = 0.1,
            drop_path_scales=None, remat: bool = False,
            divide_by_non_pads: bool = True) -> torch.Tensor:
    """The XE loss of one batch, differentiable in the model's parameters.
    batch: 'enc_input' (see the module docstring) and 'captions' (B, T) ids
    right-padded with PAD; the decoder input / target split happens here.
    drop_path_scales: the backbone's stochastic-depth scales (end to end
    only). divide_by_non_pads=False returns the sum over the tokens."""
    cap = _caption_cfg(cfg)
    captions = batch["captions"]
    dec_input, targets = captions[:, :-1], captions[:, 1:]
    dec_pads = (dec_input == cap.pad_idx).sum(dim=-1)
    if isinstance(cfg, ModelConfig):
        logits = model(_images(batch), dec_input, dec_pads, train=True, generator=generator,
                       drop_path_scales=drop_path_scales, remat=remat)
    else:
        if drop_path_scales is not None:
            raise ValueError("drop_path_scales: the caption head has no backbone")
        logits = model(batch["enc_input"], dec_input, batch.get("enc_num_pads"), dec_pads,
                       train=True, generator=generator)
    return label_smoothing_loss(logits, targets, cap.pad_idx, smoothing, divide_by_non_pads)


def make_xe_step(model, cfg, optimizer, smoothing: float = 0.1, remat: bool = False) -> Callable:
    """step(batch, generator=None, drop_path_scales=None) -> {'loss': tensor}:
    one forward with dropout and stochastic depth drawn from `generator` (off
    without one; `drop_path_scales` hands the per-block scales in instead),
    one backward, one `optimizer.step()`. The model's parameters are updated
    in place; the loss is returned detached, on the model's device. Under
    `DataParallel` the loss is the whole batch's (all data ranks' tokens).
    Recorded as the spans `xe`, `xe.forward`, `xe.backward` and
    `xe.optimizer` (`utils/profiling.py`)."""
    dp = replicated(model)
    pad = _caption_cfg(cfg).pad_idx

    def step(batch, generator=None, drop_path_scales=None):
        with span("xe"):
            optimizer.zero_grad(set_to_none=True)
            # this rank's sum over ALL data ranks' tokens, times the ranks DDP averages over
            tokens = dp.sum((batch["captions"][:, 1:] != pad).sum())
            with span("xe.forward"):
                total = dp(xe_loss, cfg, batch, generator, smoothing, drop_path_scales, remat,
                           False)
                loss = total / tokens.clamp_min(1) * dp.world
            with span("xe.backward"):
                loss.backward()
            with span("xe.optimizer"):
                optimizer.step()
            return _metrics(dp, loss, {})

    return step


def _metrics(dp, loss, metrics):
    """The step's metrics, detached: means over the data ranks."""
    return {k: dp.mean(v) for k, v in {"loss": loss, **metrics}.items()}


def _scst_rescore(model, cfg, enc, enc_pads, dtype, tokens, lengths, rewards, generator=None):
    """The SCST loss of sampled captions, differentiable in the decoder's
    parameters and in `enc`: the decoder re-scores tokens (B, N, L+1) teacher
    forced (dropout from `generator`, off without one), fp32 log-softmax;
    the log-probs of positions < lengths (B, N) are kept, EOS included
    (reference :206-215). Returns (loss, {'reward', 'baseline',
    'logprob_sum'}), the means over the batch."""
    cap = _caption_cfg(cfg)
    dev = enc.device
    b, n, lp1 = tokens.shape
    flat = tokens.to(dev).reshape(b * n, lp1).long()
    rewards = torch.as_tensor(rewards, dtype=torch.float32, device=dev)
    enc_rep = torch.repeat_interleave(enc, n, dim=0)
    pads_rep = None if enc_pads is None else torch.repeat_interleave(enc_pads.to(dev), n, dim=0)
    logp = model.forward_dec(enc_rep, flat[:, :-1], None, pads_rep, True, dtype, True,
                             generator)  # (B * N, L, V)
    step_lp = torch.gather(logp, -1, flat[:, 1:, None])[..., 0]
    keep = torch.arange(lp1 - 1, device=dev)[None, :] < lengths.to(dev).reshape(b * n, 1)
    step_lp = torch.where(keep, step_lp, 0.0).reshape(b, n, -1)
    baselines = mean_baseline(rewards)
    loss = scst_loss(step_lp, rewards, baselines)
    return loss, {"reward": rewards.mean(), "baseline": baselines.mean(),
                  "logprob_sum": step_lp.sum(-1).mean()}


def make_scst_step(model, cfg, optimizer, num_samples: int, remat: bool = False) -> Callable:
    """step(batch, sampled, rewards, generator=None) -> {'loss', 'reward',
    'baseline', 'logprob_sum'} (detached): the two-phase SCST step, after a
    sampling call and a reward computed between it and this step.

    `sampled`: {'tokens': (B, N, L+1) from decode.sampling (SOS + caption),
    'lengths': (B, N) index of the first EOS}; `rewards` (B, N), a tensor or
    numpy (CiderReward's). The encoder runs again here with train=True (so the
    backbone goes through its training kernels), then the decoder re-scores
    the samples (`_scst_rescore`); one backward, one `optimizer.step()`.
    Without a generator dropout and stochastic depth are off, so the re-score
    reproduces the sampling log-probs: the textbook unbiased REINFORCE
    gradient of the policy the captions were sampled from. A generator draws
    dropout for the encoder, then an independent draw for the re-score (the
    JAX package's rng; see its docstring for the policy mismatch that
    carries)."""
    dp = replicated(model)

    def loss_fn(m, batch, sampled, rewards, generator):
        enc, pads, dtype = _encode(m, cfg, batch, generator, remat)
        return _scst_rescore(m, cfg, enc, pads, dtype, sampled["tokens"], sampled["lengths"],
                             rewards, generator)

    def step(batch, sampled, rewards, generator=None):
        if sampled["tokens"].shape[1] != num_samples:
            raise ValueError(f"{sampled['tokens'].shape[1]} samples an image, the step was made "
                             f"for {num_samples}")
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = dp(loss_fn, batch, sampled, rewards, generator)
        loss.backward()
        optimizer.step()
        return _metrics(dp, loss, metrics)

    return step


def make_scst_fused_step(model, cfg, optimizer, num_samples: int, scst_max_len: int,
                         sos_idx: int, eos_idx: int, reward_fn: Callable, dropout: bool = False,
                         step_impl: str = "pallas", remat: bool = False) -> Callable:
    """step(batch, ref_tables, generator=None, noise=None) ->
    {'loss', 'reward', 'baseline', 'logprob_sum', 'sampled', 'rewards'}: one
    SCST step with a SHARED encoder forward. The encoder (backbone and
    expansion encoder) runs its train=True forward once; the sampler reads
    its output detached (under no_grad, fp32 caches, `step_impl` decode
    step); reward_fn(tokens, lengths, ref_tables) -> (B, N) scores the
    samples (e.g. `DeviceCiderCorpus.make_reward_fn()`; `ref_tables` is
    handed through); the decoder re-scores them differentiably in the
    parameters and the encoder output, and one backward runs through both,
    so the encoder's gradient arrives through the same graph. One
    `optimizer.step()`.

    The sampler's Gumbel noise comes from `generator` (on the model's
    device) or is handed in (`noise`, one (B * N, vocab) tensor per step);
    one of the two is required. dropout=False keeps dropout and stochastic
    depth off: sampling and re-score share one deterministic policy. With
    dropout=True the generator also draws the encoder's dropout, which the
    sampling and the gradient share (the encoder ran once), and an
    independent draw for the decoder re-score (the incremental sampler cannot
    replay the decoder's masks). 'sampled' is the sampler's SampleResult,
    'rewards' its (B, N) rewards. Recorded as the spans `scst` and, in
    order, `scst.encoder`, `scst.sampling`, `scst.reward`, `scst.rescore`
    (the teacher-forced forward), `scst.backward` and `scst.optimizer`
    (`utils/profiling.py`)."""
    cap = _caption_cfg(cfg)
    dp = replicated(model)

    def loss_fn(m, batch, ref_tables, generator, noise):
        drop_gen = generator if dropout else None
        with span("scst.encoder"):
            enc, pads, dtype = _encode(m, cfg, batch, drop_gen, remat)
        with span("scst.sampling"):
            sampled = sampling.sample(m, cap, enc.detach(), num_samples, scst_max_len, sos_idx,
                                      eos_idx, enc_num_pads=pads, step_impl=step_impl,
                                      generator=generator, noise=noise)
        with span("scst.reward"), torch.no_grad():
            rewards = reward_fn(sampled.tokens, sampled.lengths, ref_tables)
        with span("scst.rescore"):
            loss, metrics = _scst_rescore(m, cfg, enc, pads, dtype, sampled.tokens,
                                          sampled.lengths, rewards, drop_gen)
        return loss, metrics, sampled, rewards

    def step(batch, ref_tables, generator=None, noise=None):
        if generator is None and noise is None:
            raise ValueError("the SCST step samples: hand it a generator or the noise")
        with span("scst"):
            optimizer.zero_grad(set_to_none=True)
            loss, metrics, sampled, rewards = dp(loss_fn, batch, ref_tables, generator, noise)
            with span("scst.backward"):
                loss.backward()
            with span("scst.optimizer"):
                optimizer.step()
            return {**_metrics(dp, loss, metrics), "sampled": sampled,
                    "rewards": torch.as_tensor(rewards)}

    return step


class _EveryK:
    """An optimizer applied every k micro-steps on the mean of their
    gradients; between updates the gradients keep summing in `.grad`.
    `state_dict` holds the wrapped optimizer's state, the micro-step count
    and, mid-accumulation, the gradients summed so far (what
    `optax.MultiSteps` keeps in the JAX package's optimizer state), so a
    save between two updates resumes exactly."""

    def __init__(self, optimizer, k: int):
        self.optimizer, self.k, self.micro = optimizer, k, 0

    @property
    def param_groups(self):  # the optimizer's own: load_state_dict replaces them
        return self.optimizer.param_groups

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def state_dict(self) -> dict:
        grads = [None if self.micro == 0 or p.grad is None else p.grad.detach().clone()
                 for p in self._params()]
        return {"optimizer": self.optimizer.state_dict(), "micro": self.micro, "grads": grads}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.micro = int(state["micro"])
        params = self._params()
        if len(state["grads"]) != len(params):
            raise ValueError(f"{len(state['grads'])} gradients saved for {len(params)} parameters")
        for p, g in zip(params, state["grads"]):
            p.grad = None if g is None else g.to(device=p.device, dtype=p.dtype).clone()

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self.micro == 0:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.micro += 1
        if self.micro < self.k:
            return
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.div_(self.k)
        self.optimizer.step()
        self.micro = 0


def with_grad_accum(optimizer, num_accum: int):
    """The optimizer applied every `num_accum` micro-steps (itself when
    num_accum <= 1)."""
    return optimizer if num_accum <= 1 else _EveryK(optimizer, num_accum)
