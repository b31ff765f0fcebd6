"""The one traffic generator: every cell's inputs from its traffic file's
parameters and the run's seed.

What varies with the seed is which images and token ids a run sees and in
what order. The sizes do not: the structure of the work (the caption lengths
of every batch, hence every padded length) is drawn from the traffic file's
own fixed `layout_seed`, so every seed runs the same set of shapes.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of one seed (any seed below
    2**64)."""
    return np.random.default_rng([int(seed) % 2**64, *stream.encode()])


def image_pool(n: int, size: int, seed: int, device: torch.device, pin: bool) -> torch.Tensor:
    """n distinct uint8 NHWC images (n, size, size, 3), drawn on `device` from
    the seed and kept on the host (pinned where `pin`): the pool requests copy
    from. Smooth gradients plus noise, so that images differ in content and
    not only in noise."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    noise = torch.randint(0, 64, (n, size, size, 3), generator=g, device=device,
                          dtype=torch.uint8)
    ramp = torch.linspace(0, 191, size, device=device)
    phase = torch.rand((n, 1, 1, 3), generator=g, device=device)
    base = (ramp[None, :, None, None] * phase + ramp[None, None, :, None] * (1 - phase))
    pool = (base.to(torch.uint8) + noise).cpu()
    return pool.pin_memory() if pin else pool


def caption_lengths(spec: Dict, count: int, layout_seed: int) -> np.ndarray:
    """`count` caption lengths (SOS and EOS included) from the pmf
    spec["pmf"] over spec["min"] ... spec["max"], by a fixed draw."""
    lengths = np.arange(spec["min"], spec["max"] + 1)
    pmf = np.asarray(spec["pmf"], dtype=np.float64)
    if len(pmf) != len(lengths):
        raise ValueError(f"pmf has {len(pmf)} weights for lengths {spec['min']}..{spec['max']}")
    return rng(layout_seed, "lengths").choice(lengths, size=count, p=pmf / pmf.sum())


def caption_batches(traffic: Dict, cap_cfg: Dict, seed: int) -> List[torch.Tensor]:
    """traffic["batches"] caption batches (B, longest) int64: SOS, random
    ids outside the special ids, EOS, then PAD to the batch's longest (as the
    loader pads). The lengths of every batch are fixed by the layout seed;
    the seed draws the ids and the order of the batches."""
    b, n = traffic["batch"], traffic["batches"]
    lengths = caption_lengths(traffic["caption_len"], b * n, traffic["layout_seed"]).reshape(n, b)
    specials = {cap_cfg[k] for k in ("sos_idx", "eos_idx", "pad_idx", "unk_idx")}
    low = max(specials) + 1
    r = rng(seed, "captions")
    out = []
    for i in r.permutation(n):
        longest = int(lengths[i].max())
        caps = np.full((b, longest), cap_cfg["pad_idx"], dtype=np.int64)
        for j, ln in enumerate(lengths[i]):
            caps[j, 0] = cap_cfg["sos_idx"]
            caps[j, 1:ln - 1] = r.integers(low, cap_cfg["vocab_size"], ln - 2)
            caps[j, ln - 1] = cap_cfg["eos_idx"]
        out.append(torch.from_numpy(caps))
    return out


def pool_batch(pool: torch.Tensor, batch: int, index: int) -> torch.Tensor:
    """Batch `index`: the next `batch` rows of the pool, read in order and
    cycled; a contiguous view, so a pinned pool copies asynchronously."""
    if pool.shape[0] % batch:
        raise ValueError(f"a pool of {pool.shape[0]} images does not split into batches of {batch}")
    start = (index * batch) % pool.shape[0]
    return pool[start:start + batch]
