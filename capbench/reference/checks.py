"""The comparisons that decide `correct`: the plain reference
(`reference/model.py`, float32 with TF32 off) recomputes what the timed path
produced, from the same seeded weights and inputs, and each compared number
is held to its limit (a number passes when it is at most its limit).

Nothing here imports the program under test. The weights are drawn again
from the seed (`capbench/weights.py`), never read from the program.

Numbers:

- feat_tail, enc_tail: the backbone's features and the caption encoder's
  output of a request (or the rows written to a feature store), by
  `tail_share`: the largest share, over images, of elements off by more
  than TOL x the image's mean magnitude. A relative norm of the error does
  not separate the bf16 program from its int8 control (1.3% against 3.4%);
  the share of elements past 5% does (0.3% against 25%);
- lp_share, rank_share: the served tokens (`served_shares`);
- the training numbers: see `train_numbers` and `late_numbers`.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..weights import draw_weights
from . import model as R
from .radam import RAdam

# the tolerance of a tail share: an element is off when its error exceeds
# this share of its image's mean magnitude
TOL = 0.05
# the tolerance of a served token's log-prob, in nats
LP_TOL = 0.05
# the output head: the leaves whose gradient reaches them from the loss
# without passing back through a dynamic expansion's scores
HEAD = ("vocab_linear.", "dec_reduce_norm.", "dec_reduce_group.")


def rel_rows(port: torch.Tensor, ref: torch.Tensor) -> float:
    """max over the leading axis of |port - ref| / |ref|."""
    port, ref = port.float().to(ref.device), ref.float()
    d = (port - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1).clamp_min(1e-30)
    return float(d.max())


def _numbers(values: Dict[str, float], limits: Dict[str, float]) -> List[Tuple[str, float, float]]:
    return [(k, float(v), float(limits[k])) for k, v in values.items()]


def tail_share(port: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """The largest, over the leading axis (images), share of elements whose
    |port - ref| exceeds tol x that image's mean |ref|."""
    port, ref = port.float().to(ref.device), ref.float()
    scale = ref.abs().flatten(1).mean(1).clamp_min(1e-30)
    off = (port - ref).abs().flatten(1) > tol * scale[:, None]
    return float(off.float().mean(1).max())


def rel_stats(port: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """Diagnostics: relative error of the worst image and token row, and
    tail shares at several tolerances."""
    port, ref = port.float().to(ref.device), ref.float()
    diff = port - ref
    tok = diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    out = {"rel": rel_rows(port, ref), "tok_max": float(tok.max())}
    for tol in (0.03, 0.05, 0.08):
        out[f"tail{tol}"] = tail_share(port, ref, tol)
    return out


def served_gaps(logp: torch.Tensor, caps: Sequence, lps: Sequence, beam: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per served token of one request: (|port - ref| of its log-prob, the
    amount its reference log-prob lies below the reference's beam-th best).
    logp (B, T, V) reference log-probs over the teacher-forced served
    captions; caps / lps the served tokens and log-probs (the best caption
    of each image)."""
    gaps, ranks = [], []
    kth = logp.topk(beam, dim=-1).values[..., -1]  # (B, T)
    for b, (toks, vals) in enumerate(zip(caps, lps)):
        toks, vals = toks[0], vals[0]
        n = len(toks)
        if n < 2:
            continue
        idx = torch.tensor(toks[1:], device=logp.device).long()
        ref = logp[b, torch.arange(n - 1, device=logp.device), idx]
        port = torch.tensor(vals[1:], device=logp.device, dtype=torch.float32)
        gaps.append((port - ref).abs())
        ranks.append((kth[b, :n - 1] - ref).clamp_min(0))
    return torch.cat(gaps), torch.cat(ranks)


def control_gaps(logp: torch.Tensor, low: torch.Tensor, caps: Sequence, beam: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The control's readings at the positions of the same served tokens:
    (|low - ref| of each served token's log-prob, and for each of the
    `beam` tokens the lower precision puts first, the amount its reference
    log-prob lies below the reference's beam-th best). low (B, T, V): the
    lower precision's log-probs over the same teacher-forced captions."""
    kth = logp.topk(beam, dim=-1).values[..., -1:]  # (B, T, 1)
    picks = logp.gather(-1, low.topk(beam, dim=-1).indices)  # (B, T, beam)
    ranks = (kth - picks).clamp_min(0)
    gaps, rk = [], []
    for b, c in enumerate(caps):
        n = len(c[0])
        if n < 2:
            continue
        idx = torch.tensor(c[0][1:], device=logp.device).long()[:, None]
        gaps.append((low[b, :n - 1].gather(-1, idx) - logp[b, :n - 1].gather(-1, idx)).abs()[:, 0])
        rk.append(ranks[b, :n - 1].flatten())
    return torch.cat(gaps), torch.cat(rk)


def _tokens(caps: Sequence, pad: int, device) -> torch.Tensor:
    longest = max(len(c[0]) for c in caps)
    out = torch.full((len(caps), longest), pad, dtype=torch.long)
    for b, c in enumerate(caps):
        out[b, :len(c[0])] = torch.tensor(c[0])
    return out.to(device)


def served_shares(gaps: torch.Tensor, ranks: torch.Tensor, diag: Optional[Dict],
                  prefix: str = "") -> Dict[str, float]:
    """lp_share: the share of served tokens whose log-prob is off the
    reference's by more than LP_TOL; rank_share: the share lying more than
    LP_TOL below the reference's beam-th best (out of the beam). Shares, not
    the widest gap: the decoder's dynamic expansion normalises relu(z) over
    a causal prefix with eps 1e-9, so a score z near 0 switches a slot on or
    off, rounding flips such signs in any precision, and a flip moves a few
    tokens by up to 0.3 nats. A flip is rare; a precision's rounding, a
    broken step or search, or an altered token moves many."""
    out = {"lp_share": float((gaps > LP_TOL).float().mean()),
           "rank_share": float((ranks > LP_TOL).float().mean())}
    if diag is not None:
        diag.update({prefix + "lp_med": float(gaps.median()), prefix + "lp_max": float(gaps.max()),
                     prefix + "rank_max": float(ranks.max()), prefix + "tokens": int(gaps.numel()),
                     **{prefix + k: v for k, v in out.items()}})
    return out


@torch.no_grad()
def serve_numbers(cfg, shapes, seed, device, images: Dict[int, torch.Tensor],
                  served: Dict[int, tuple], captured: Dict[int, Dict[str, torch.Tensor]],
                  beam: int, limits: Dict[str, float], diag=None,
                  low: Optional[str] = None) -> List[tuple]:
    """images, served and captured: request -> its uint8 images, its
    (captions, log-probs), its backbone features and encoder output.

    The reference checks the backbone and the encoder from the images, and
    scores the served tokens teacher forced from the program's own encoder
    output, which enc_tail checks by itself: so a decode number reads the
    decode alone. With `low` ("fp8") the decode numbers are the control's:
    the reference's decoder in that precision, at the same positions."""
    p = draw_weights(shapes, seed, device)
    cap = cfg["captioner"]
    prec, nodrop = R.Precision("fp32"), R.Drop(None)
    vals = {"feat_tail": 0.0, "enc_tail": 0.0}
    gaps, ranks = [], []
    with R.fp32_matmul():
        for i, x in images.items():
            feats = R.swin(R.normalize(x.to(device)), p, cfg["swin"], prec)
            enc = R.caption_encoder(feats, p, cap, prec, nodrop)
            got = captured[i]
            vals["feat_tail"] = max(vals["feat_tail"], tail_share(got["features"], feats, TOL))
            vals["enc_tail"] = max(vals["enc_tail"], tail_share(got["cross"], enc, TOL))
            if diag is not None:
                for name, a, b in (("feat_", got["features"], feats), ("enc_", got["cross"], enc)):
                    for k, v in rel_stats(a, b).items():
                        diag[name + k] = max(diag.get(name + k, 0.0), v)
            del feats, enc
            caps, lps = served[i]
            toks = _tokens(caps, cap["pad_idx"], device)[:, :-1]
            cross = got["cross"].to(device).float()
            logp = R.caption_decoder(cross, toks, p, cap, prec, nodrop).log_softmax(-1)
            if low is None:
                g, r = served_gaps(logp, caps, lps, beam)
            else:
                lowp = R.caption_decoder(cross, toks, p, cap, R.Precision(low),
                                         nodrop).log_softmax(-1)
                g, r = control_gaps(logp, lowp, caps, beam)
            gaps.append(g)
            ranks.append(r)
    vals.update(served_shares(torch.cat(gaps), torch.cat(ranks), diag))
    return _numbers(vals, limits)


@torch.no_grad()
def features_numbers(cfg, shapes, seed, device, images: Dict[int, torch.Tensor],
                     rows: Dict[int, torch.Tensor], limits: Dict[str, float],
                     diag=None) -> List[tuple]:
    """rows: store row id -> the written features; images: the same ids ->
    the uint8 image the row was made from."""
    p = draw_weights(shapes, seed, device)
    ids = sorted(rows)
    worst = 0.0
    with R.fp32_matmul():
        for start in range(0, len(ids), 8):
            part = ids[start:start + 8]
            x = torch.stack([images[i] for i in part]).to(device)
            ref = R.swin(R.normalize(x), p, cfg["swin"], R.Precision("fp32"))
            got = torch.stack([rows[i] for i in part])
            worst = max(worst, tail_share(got, ref, TOL))
            if diag is not None:
                for k, v in rel_stats(got, ref).items():
                    diag[k] = max(diag.get(k, 0.0), v)
    return _numbers({"feat_tail": worst}, limits)


def train_reference(cfg, p0: Dict[str, torch.Tensor], device,
                    batches: List[Dict[str, torch.Tensor]], generator: torch.Generator,
                    precision: str = "fp32", opt_state: Optional[Dict] = None) -> Dict:
    """The reference's own run of checked steps from the parameters p0 (the
    seed's, or a state of the program's) and RAdam's state (`opt_state`:
    mu, nu, count; empty moments at the configuration's count without one):
    the same batches, the dropout masks from `generator` (in the state the
    program's was), label smoothing. Returns {"loss": [...], "grad": {leaf:
    norm of the first step's gradient}, "update": {leaf: norm of the change
    after the steps}, "features": the first step's backbone features}."""
    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    cap = cfg["captioner"]
    opt = RAdam(params, cfg["optimizer"], opt_state)
    prec, drop = R.Precision(precision), R.Drop(generator)
    out = {"loss": [], "grad": {}, "update": {}, "features": None}
    with R.fp32_matmul():
        for step, batch in enumerate(batches):
            images, caps = batch["images"].to(device), batch["captions"].to(device)
            feats = R.swin(R.normalize(images), params, cfg["swin"], prec)
            if step == 0:
                out["features"] = feats.detach().float().cpu()
            enc = R.caption_encoder(feats, params, cap, prec, drop)
            logits = R.caption_decoder(enc, caps[:, :-1], params, cap, prec, drop)
            targets = caps[:, 1:]
            loss = (R.label_smoothing(logits, targets, cap["pad_idx"], cfg["label_smoothing"])
                    / (targets != cap["pad_idx"]).sum())
            grads = torch.autograd.grad(loss, list(params.values()))
            del feats, enc, logits
            out["loss"].append(float(loss.detach()))
            g = dict(zip(params, grads))
            if step == 0:
                out["grad"] = {k: float(v.norm()) for k, v in g.items()}
            opt.step(g)
            del g, grads
    with torch.no_grad():
        out["update"] = {k: float((params[k] - p0[k]).norm()) for k in params}
    return out


@torch.no_grad()
def optimizer_gaps(cfg, p0: Dict[str, torch.Tensor], opt_state: Optional[Dict],
                   grads: Dict[str, torch.Tensor], p1: Dict[str, torch.Tensor]
                   ) -> Dict[str, float]:
    """The program's optimizer step against the reference RAdam's from the
    same parameters, state and gradient (the program's own, as its first
    moment records it): leaf -> |p1 - p_ref| / |p_ref - p0|, the first over
    the reference's change. This follows the program's own gradient; the
    gradient is judged by itself (`train_numbers`)."""
    params = {k: v.clone() for k, v in p0.items()}
    RAdam(params, cfg["optimizer"], opt_state).step(grads)
    return {k: float((p1[k].to(v.device) - v).norm())
            / max(float((v - p0[k]).norm()), 1e-30) for k, v in params.items()}


def _worst(gaps: Dict[str, float], keys) -> float:
    return max(gaps[k] for k in keys)


def train_numbers(port: Dict, ref: Dict, limits: Dict[str, float], diag=None,
                  opt: Optional[Dict[str, float]] = None, suffix: str = "") -> List[tuple]:
    """Compare the program's checked steps with the reference's:

    - loss_gap: the largest relative gap of a checked step's loss;
    - feat_tail: `tail_share` of the first step's backbone features (1 where
      the program produced none for some image; where the program has them);
    - head_grad_gap: the first step's gradient, as the program's optimizer
      got it, at the output head's leaves (HEAD): the worst leaf's
      |norm_port - norm_ref| over max(norm_ref, the median leaf's). A
      gradient that reaches a leaf back through a dynamic expansion's scores
      is led by the few scores nearest 0, where d/dz of relu(z) / (sum + eps)
      is of the order of eps / z^2, and rounding moves those scores: the
      worst leaf of the whole model reads 0.16-0.96 in sound runs. The head
      sits before them: a gradient that leaves out half of the batch moves
      its norm by about sqrt(2);
    - opt_gap: the worst leaf of `optimizer_gaps` (given as `opt`);
    - update_gap: the parameters' change after the checked steps at the
      output head's leaves, by the worst leaf: |norm_port - norm_ref| over
      max(norm_ref, the median leaf's). Over the whole model the worst leaf
      reads 0.06-0.23 in sound runs: RAdam moves each element by about lr
      whatever its gradient's size, so the change's norm follows the signs
      of the gradients, and these are rounding's in the fused qkv biases'
      key thirds (nought gradients under the softmax, in a leaf whose other
      thirds move) and the flips' in the expansions' query and key leaves.

    Leaves whose reference gradient is below a thousandth of the median
    leaf's (nought to rounding, such as a key bias under the softmax) are
    left out of the changes: Adam moves them by round-off alone."""
    med = statistics.median(ref["grad"].values())
    moving = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    values = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(port["loss"], ref["loss"]))}
    if "features" in port:
        feats, rfeats = port["features"], ref["features"]
        values["feat_tail"] = (1.0 if feats is None or feats.shape != rfeats.shape
                               else tail_share(feats, rfeats, TOL))
    grad_gaps = {k: abs(port["grad"][k] - v) / max(v, med) for k, v in ref["grad"].items()}
    values["head_grad_gap"] = _worst(grad_gaps, [k for k in grad_gaps if k.startswith(HEAD)])
    if opt is not None:
        values["opt_gap"] = _worst(opt, moving)
    if "update" in port:
        umed = statistics.median(ref["update"][k] for k in moving)
        update_gaps = {k: abs(port["update"][k] - ref["update"][k]) / max(ref["update"][k], umed)
                       for k in moving}
        values["update_gap"] = _worst(update_gaps, [k for k in update_gaps if k.startswith(HEAD)])
        if diag is not None:
            diag["update_gap_all" + suffix] = max(update_gaps.values())
            diag["update_med_gap" + suffix] = statistics.median(update_gaps.values())
            diag["update_worst" + suffix] = sorted(
                ((v, k) for k, v in update_gaps.items()), reverse=True)[:3]
    if diag is not None:
        diag["loss" + suffix] = [port["loss"], ref["loss"]]
        diag["grad_gap" + suffix] = max(grad_gaps.values())
        diag["grad_med_gap" + suffix] = statistics.median(grad_gaps.values())
        diag["grad_worst" + suffix] = sorted(((v, k) for k, v in grad_gaps.items()),
                                             reverse=True)[:3]
        if opt is not None:
            diag["opt_worst" + suffix] = sorted(((opt[k], k) for k in moving), reverse=True)[:3]
    return _numbers({k + suffix: v for k, v in values.items()}, limits)
