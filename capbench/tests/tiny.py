"""Tiny configurations and traffic for the CPU rehearsals: the cells'
files with every size cut down and every limit kept."""
from __future__ import annotations

import copy

from capbench.manifest import Manifest

TINY_SWIN = {"img_size": 128, "patch_size": 4, "embed_dim": 16, "depths": [2, 2, 6],
             "num_heads": [2, 4, 8], "window_size": 4}
TINY_CAP = {"d_model": 32, "N_enc": 2, "N_dec": 2, "ff": 64, "num_heads": 4,
            "num_exp_enc_list": [4, 8], "num_exp_dec": 4, "vocab_size": 60, "max_seq_len": 24,
            "img_feature_dim": 64, "sos_idx": 1, "eos_idx": 2, "pad_idx": 0, "unk_idx": 3}
TINY_TRAFFIC = {"batch": 2, "pool_images": 8, "batches": 4, "warmup_requests": 1,
                "check_requests": 2, "batches_per_call": 2,
                "warmup_batches": 1, "check_rows": 2, "checked_steps": 3}


def tiny(cell: str, compute_dtype: str = "float32"):
    """(config, traffic) of a cell, cut to a CPU's size, computing in fp32 so
    that the program's plain kernels agree with the reference."""
    m = Manifest()
    w = m.workload(cell)
    cfg = copy.deepcopy(m.config(w["config"]))
    cfg["swin"].update(TINY_SWIN)
    cfg["captioner"].update(TINY_CAP)
    cfg["compute_dtype"] = compute_dtype
    traffic = copy.deepcopy(m.traffic(w["traffic"]))
    traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
    if "max_seq_len" in traffic:
        traffic["max_seq_len"] = 8
    if "caption_len" in traffic:
        traffic["caption_len"] = {"min": 4, "max": 8, "pmf": [1, 2, 3, 2, 1]}
    return cfg, traffic
