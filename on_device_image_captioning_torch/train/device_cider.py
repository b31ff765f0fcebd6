"""CIDEr-D rewards computed on the card: the SCST loop with no host round trip
(counterpart of the JAX package's `train/device_cider.py`).

The host path (train/scst.py::CiderReward) ships the sampled tokens to the
host, scores them there and ships the rewards back for the gradient step
(reference losses/reward.py:30-89 + eval/cider/reinforce_cider.py). This module
evaluates the same CIDEr-D (evalcap/cider.py semantics) in tensor code on the
tables' device, so sample -> reward -> REINFORCE gradient never leaves the card.

Design (all shapes fixed by the corpus and the batch):
- n-grams are packed EXACTLY into two int32 lanes (15 bits per token id:
  vocabulary + out-of-vocab reference words + padding sentinel), so matching
  is integer equality, no hash collisions on the match path.
- each image's reference vectors are tiny tables gathered per batch on the
  host (ids, tf, norms, bigram lengths): a numpy fancy-index, not scoring.
- the candidate's idf weights come from a device-resident open-addressing
  hash table of the corpus document frequencies (built once by the numpy
  host code below, a copy of the JAX package's; fixed probe depth measured at
  build time). A miss yields idf = log(N): exactly the df=0 case of the host
  scorer. The hash is uint32 arithmetic, done here in int64 masked to 32 bits
  so that every probe bit-agrees with the host insert.
- candidate term frequencies / clipped numerators run per n-gram INSTANCE:
  sums over distinct grams with tf weights become instance sums divided by
  the instance's tf, so everything is fixed-shape elementwise work.

Parity: tests/test_torch_cider.py holds the tables to the JAX package's bit
for bit and the scores to the JAX scorer's and to CiderReward's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.text import Vocab, clean_caption

N = 4
SIGMA = 6.0
TOKEN_BITS = 15
TOKEN_MASK = (1 << TOKEN_BITS) - 1
PAD_TOKEN_ID = TOKEN_MASK  # never a real token; pads n-gram windows
_H1 = np.uint32(0x9E3779B1)
_H2 = np.uint32(0x85EBCA6B)
_U32 = 0xFFFFFFFF


def _pack(window: Sequence[int]) -> tuple:
    """Token-id window (len 1..4) -> (lo, hi) int32 exact packing."""
    w = list(window) + [PAD_TOKEN_ID] * (4 - len(window))
    lo = (w[0] & TOKEN_MASK) | ((w[1] & TOKEN_MASK) << TOKEN_BITS)
    hi = (w[2] & TOKEN_MASK) | ((w[3] & TOKEN_MASK) << TOKEN_BITS)
    return np.int32(np.uint32(lo)), np.int32(np.uint32(hi))


class DeviceCiderCorpus:
    """Host-side preprocessing: per-image reference tables + the corpus df
    hash table, ready to feed `cider_reward` (the device scorer).

    training_references: list over images of raw caption strings — the same
    input train/scst.CiderReward takes; cleaned + ' EOS'-framed identically.
    vocab: token-id mapping for the DEVICE-side candidate tokens. Reference
    words outside the vocab get private extended ids (beyond vocab_size) so
    distinct OOV words never alias each other or UNK."""

    def __init__(
        self,
        training_references: Sequence[List[str]],
        vocab: Vocab,
        eos_token: str = "EOS",
        max_refs: Optional[int] = None,
        table_load: float = 0.5,
    ):
        # token ids must fit the 15-bit packing, and PAD_TOKEN_ID must stay
        # impossible — a bigger vocab would silently alias distinct tokens
        assert len(vocab) < PAD_TOKEN_ID, (
            f"vocab size {len(vocab)} >= {PAD_TOKEN_ID} overflows the "
            f"{TOKEN_BITS}-bit n-gram packing"
        )
        self.vocab = vocab
        ext: Dict[str, int] = {}
        next_ext = [len(vocab)]
        self._oov_overflow = 0
        eos_idx = vocab.eos_idx

        def tok_id(w: str) -> int:
            i = vocab.word2idx.get(w)
            if i is not None:
                return i
            i = ext.get(w)
            if i is None:
                if next_ext[0] < PAD_TOKEN_ID:
                    i = next_ext[0]
                    next_ext[0] += 1
                else:  # ran out of 15-bit ids: distinct OOVs share one bucket
                    self._oov_overflow += 1
                    i = PAD_TOKEN_ID - 1
                ext[w] = i
            return i

        # tokenize refs to ids with the CiderReward framing (clean + EOS)
        self.ref_ids_per_image: List[List[List[int]]] = []
        for refs in training_references:
            image = []
            for r in refs[: max_refs or len(refs)]:
                words = clean_caption(r).split()
                image.append([tok_id(w) for w in words] + [eos_idx])
            self.ref_ids_per_image.append(image)

        n_images = len(self.ref_ids_per_image)
        self.log_ref_len = float(np.log(max(float(n_images), 1.0)))

        # document frequencies over distinct grams per image
        df: Dict[tuple, float] = {}
        cooked = []  # per image: list over refs of {gram(lo,hi,n): tf}
        for image in self.ref_ids_per_image:
            per_ref = []
            image_grams = set()
            for ids in image:
                counts: Dict[tuple, int] = {}
                for n in range(1, N + 1):
                    for i in range(len(ids) - n + 1):
                        g = (*_pack(ids[i : i + n]), n)
                        counts[g] = counts.get(g, 0) + 1
                per_ref.append(counts)
                image_grams.update(counts)
            for g in image_grams:
                df[g] = df.get(g, 0.0) + 1.0
            cooked.append(per_ref)

        def idf_of(g):
            return self.log_ref_len - np.log(max(1.0, df.get(g, 0.0)))

        # ---- per-image per-ref tables (padded) ----
        self.max_refs = max(len(im) for im in cooked) if cooked else 1
        m = 1
        for im in cooked:
            for ref in im:
                per_n = [0] * N
                for (_, _, n), _tf in ref.items():
                    per_n[n - 1] += 1
                m = max(m, *per_n)
        self.max_entries = m
        R, M = self.max_refs, self.max_entries
        shape = (n_images, R, N, M)
        self.ref_lo = np.zeros(shape, np.int32)
        self.ref_hi = np.zeros(shape, np.int32)
        self.ref_tf = np.zeros(shape, np.float32)
        self.ref_norm = np.zeros((n_images, R, N), np.float32)
        self.ref_blen = np.zeros((n_images, R), np.float32)  # bigram length
        self.ref_valid = np.zeros((n_images, R), np.float32)
        for i, im in enumerate(cooked):
            for r, ref in enumerate(im):
                self.ref_valid[i, r] = 1.0
                slot = [0] * N
                for (lo, hi, n), tf in sorted(ref.items()):
                    k = n - 1
                    s = slot[k]
                    self.ref_lo[i, r, k, s] = lo
                    self.ref_hi[i, r, k, s] = hi
                    self.ref_tf[i, r, k, s] = tf
                    # no per-entry idf table is kept: a MATCHING candidate
                    # gram has the same idf, which the device scorer looks up
                    # once from the df hash table (in cider_reward)
                    w = idf_of((lo, hi, n))
                    self.ref_norm[i, r, k] += (tf * w) ** 2
                    if n == 2:
                        self.ref_blen[i, r] += tf
                    slot[k] += 1
                # pad entries keep lo=hi=0 with tf=0: (0,0) can collide with
                # a real all-PAD gram never produced by real tokens, and tf=0
                # contributes nothing either way
        self.ref_norm = np.sqrt(self.ref_norm)

        # ---- corpus df hash table (per n, open addressing, linear probe) ----
        self.tables = []
        for n in range(1, N + 1):
            grams = [(g[0], g[1]) for g in df if g[2] == n]
            size = 8
            while size < len(grams) / table_load + 1:
                size *= 2
            keys_lo = np.zeros(size, np.int32)
            keys_hi = np.zeros(size, np.int32)
            used = np.zeros(size, bool)
            vals = np.zeros(size, np.float32)
            max_probe = 0
            for lo, hi in grams:
                with np.errstate(over="ignore"):  # uint32 wraparound intended
                    h = int(
                        (np.uint32(lo) * _H1) ^ (np.uint32(hi) * _H2)
                    ) & (size - 1)
                p = 0
                while used[h]:
                    h = (h + 1) & (size - 1)
                    p += 1
                used[h] = True
                keys_lo[h] = lo
                keys_hi[h] = hi
                vals[h] = idf_of((lo, hi, n))
                max_probe = max(max_probe, p)
            # unused slots must MISS every real key: a zero key collides with
            # nothing real except the all-zeros gram — if that gram exists it
            # was inserted first; mark unused slots with an impossible key
            keys_lo[~used] = -1
            self.tables.append(
                {
                    "lo": keys_lo, "hi": keys_hi, "idf": vals,
                    "probes": max_probe + 1, "size": size,
                }
            )

        if self._oov_overflow:
            import warnings

            warnings.warn(
                f"DeviceCiderCorpus: {self._oov_overflow} out-of-vocabulary "
                f"reference words exceeded the {TOKEN_BITS}-bit id space and "
                "share one bucket — their df/tf (and rewards touching them) "
                "are slightly off; shrink the corpus or grow TOKEN_BITS",
                stacklevel=2,
            )

    def batch(self, image_indices) -> Dict[str, np.ndarray]:
        """Gather the per-image reference tables for a batch (host, cheap)."""
        idx = np.asarray(image_indices)
        return {
            "ref_lo": self.ref_lo[idx],
            "ref_hi": self.ref_hi[idx],
            "ref_tf": self.ref_tf[idx],
            "ref_norm": self.ref_norm[idx],
            "ref_blen": self.ref_blen[idx],
            "ref_valid": self.ref_valid[idx],
        }

    def device_tables(self, device="cuda") -> Dict[str, torch.Tensor]:
        """The corpus-wide df hash tables, placed once on `device` (the card
        unless the caller asks for the CPU)."""
        out = {}
        for k, t in enumerate(self.tables):
            out[f"df{k}_lo"] = torch.as_tensor(t["lo"], device=device)
            out[f"df{k}_hi"] = torch.as_tensor(t["hi"], device=device)
            out[f"df{k}_idf"] = torch.as_tensor(t["idf"], device=device)
        return out

    @property
    def probe_depths(self):
        return tuple(t["probes"] for t in self.tables)

    def make_reward_fn(self, device="cuda"):
        """reward_fn(tokens, lengths, ref_tables) -> (B, S): `cider_reward`
        closed over this corpus's df hash tables (placed on `device` once).
        The wiring point for train_step.make_scst_fused_step's reward_fn;
        `ref_tables` is `batch(image_indices)` (numpy, moved to the tokens'
        device) or the same tables already there."""
        df_tables = self.device_tables(device)
        probes, logn = self.probe_depths, self.log_ref_len

        def reward_fn(tokens, lengths, ref_tables):
            return cider_reward(tokens, lengths, ref_tables, df_tables, probes, logn)

        return reward_fn


def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant b,
    in two 16-bit halves of a so that no product leaves int64."""
    low = (a & 0xFFFF) * b
    high = (((a >> 16) * b) & 0xFFFF) << 16
    return (low + high) & _U32


def _df_lookup(lo, hi, t_lo, t_hi, t_idf, probes: int, log_ref_len: float):
    """idf of each packed gram via fixed-depth linear probing; miss -> log N
    (the df=0 branch of the host scorer)."""
    size = t_lo.shape[0]
    # the host tables' insert hash (_H1 / _H2), bit for bit: uint32
    # products and xor, masked to the table size
    h = _mul_u32(lo.long() & _U32, int(_H1)) ^ _mul_u32(hi.long() & _U32, int(_H2))
    h = h & (size - 1)
    idf = torch.full(lo.shape, log_ref_len, dtype=torch.float32, device=lo.device)
    done = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    for _ in range(probes):
        k_lo, k_hi, k_idf = t_lo[h], t_hi[h], t_idf[h]
        hit = (k_lo == lo) & (k_hi == hi) & ~done
        empty = (k_lo == -1) & ~done
        idf = torch.where(hit, k_idf, idf)
        done = done | hit | empty
        h = (h + 1) & (size - 1)
    return idf


def cider_reward(
    tokens: torch.Tensor,  # (B, S, L+1) int sampled captions incl. SOS
    lengths: torch.Tensor,  # (B, S) index of first EOS (== #tokens after SOS)
    batch_tables: Dict[str, torch.Tensor],
    df_tables: Dict[str, torch.Tensor],
    probe_depths,
    log_ref_len: float,
) -> torch.Tensor:
    """CIDEr-D of each sampled caption against its image's references, on
    the tokens' device. Returns (B, S) fp32: the same x10-scaled scores
    CiderReward produces. `batch_tables` may be numpy (`batch()`'s output).

    The scored token stream is tokens[:, :, 1:len+1] (drop SOS, keep EOS):
    train/scst.CiderReward's framing."""
    dev = tokens.device
    b, s, lp1 = tokens.shape
    rows = b * s
    L = lp1 - 1
    toks = tokens[:, :, 1:].reshape(rows, L).long()
    lens = lengths.reshape(rows).to(dev).long()

    # broadcast ref tables over the S samples of each image
    def rep(name):
        return torch.repeat_interleave(torch.as_tensor(batch_tables[name], device=dev), s, dim=0)

    ref_lo = rep("ref_lo")  # (rows, R, N, M)
    ref_hi = rep("ref_hi")
    ref_tf = rep("ref_tf")
    ref_norm = rep("ref_norm")  # (rows, R, N)
    ref_blen = rep("ref_blen")  # (rows, R)
    ref_valid = rep("ref_valid")  # (rows, R)

    pos = torch.arange(L, device=dev)[None, :].expand(rows, L)
    toks_p = torch.where(pos < lens[:, None], toks, PAD_TOKEN_ID)

    def shifted(k):  # token at window position +k, PAD beyond the caption
        z = torch.roll(toks_p, -k, dims=1)
        return torch.where(pos < lens[:, None] - k, z, PAD_TOKEN_ID)

    t0, t1, t2, t3 = toks_p, shifted(1), shifted(2), shifted(3)
    pad = torch.full_like(t0, PAD_TOKEN_ID)

    sims = []
    cand_blen = torch.clamp(lens.float() - 1.0, min=0.0)
    delta = cand_blen[:, None] - ref_blen  # (rows, R)
    len_pen = torch.exp(-(delta**2) / (2.0 * SIGMA**2))

    for n in range(1, N + 1):
        k = n - 1
        parts = [t0, t1, t2, t3][:n] + [pad] * (4 - n)
        lo = (parts[0] & TOKEN_MASK) | ((parts[1] & TOKEN_MASK) << TOKEN_BITS)
        hi = (parts[2] & TOKEN_MASK) | ((parts[3] & TOKEN_MASK) << TOKEN_BITS)
        valid = (pos < (lens[:, None] - (n - 1))).float()  # (rows, L)

        # candidate term frequency per instance (within-row equality)
        eq = ((lo[:, :, None] == lo[:, None, :])
              & (hi[:, :, None] == hi[:, None, :])).float()
        tf_h = torch.einsum("rjk,rk->rj", eq, valid)  # counts incl. self
        tf_h = torch.clamp(tf_h, min=1.0)  # avoid 0/0 on invalid windows

        idf = _df_lookup(
            lo, hi, df_tables[f"df{k}_lo"], df_tables[f"df{k}_hi"],
            df_tables[f"df{k}_idf"], probe_depths[k], log_ref_len,
        )  # (rows, L)
        vh = tf_h * idf  # distinct-vector value of this instance's gram
        norm_h = torch.sqrt(torch.sum(valid * idf * idf * tf_h, dim=1))  # (rows,)

        # match instances against each ref's distinct-gram table
        m_eq = ((lo[:, None, :, None] == ref_lo[:, :, k, None, :])
                & (hi[:, None, :, None] == ref_hi[:, :, k, None, :])).float()  # (rows, R, L, M)
        tf_r = torch.einsum("rlwm,rlm->rlw", m_eq, ref_tf[:, :, k])  # (rows, R, L)
        # same gram -> same idf: the candidate's looked-up idf applies
        vr = tf_r * idf[:, None, :]
        num = torch.sum(
            valid[:, None, :] * torch.minimum(vh[:, None, :], vr) * vr / tf_h[:, None, :],
            dim=2,
        )  # (rows, R)
        denom = norm_h[:, None] * ref_norm[:, :, k]
        sim = torch.where(denom > 0, num / torch.clamp(denom, min=1e-12), 0.0)
        sims.append(sim * len_pen)

    per_ref = sum(sims) / float(N)  # mean over n of per-ref similarities
    n_refs = torch.clamp(torch.sum(ref_valid, dim=1), min=1.0)
    score = torch.sum(per_ref * ref_valid, dim=1) / n_refs * 10.0
    return score.reshape(b, s)
