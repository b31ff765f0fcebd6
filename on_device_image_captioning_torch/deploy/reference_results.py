"""The reference's recorded benchmark/ablation tables, as data (the port's
copy of the JAX package's `deploy/reference_results.py`).

Capability parity with benchmarking/plotting.py, which hard-codes the fork's
course-run results for 8 model variants (reference benchmarking/plotting.py:3-50)
so they can be plotted against new measurements. Values below are copied from the
reference's own published tables (see BASELINE.md for provenance); use
`plot_comparison` to chart a new measurement against them (matplotlib is
imported there only).
"""
from __future__ import annotations

from typing import Dict, Optional

# reference benchmarking/plotting.py:22-24 — parameter counts
PARAMS = {
    "baseline": 233_803_076,
    "minus_1_enc": 229_372_740,
    "minus_1_enc_1_dec": 224_627_524,
}

# reference benchmarking/plotting.py:32 — thop GFLOPs of the full beam-5 call
GFLOPS = {"baseline": 158.0}

# reference benchmarking/plotting.py:41-50 (set A) and :94 (set B)
LATENCY_S = {
    "baseline": 1.753,
    "minus_1_enc": 1.560,
    "minus_1_enc_1_dec": 1.478,
    "baseline_set_b": 45.77,
}

# reference README.md:98-106 — Karpathy test, single model (rf_model.pth)
KARPATHY_TEST_SINGLE = {
    "Bleu_1": 0.828, "Bleu_4": 0.415, "METEOR": 0.303, "ROUGE_L": 0.605,
    "CIDEr": 1.404, "SPICE": 0.245,
}

# reference README.md:89-97 — Karpathy test, ensemble
KARPATHY_TEST_ENSEMBLE = {
    "Bleu_1": 0.835, "Bleu_4": 0.427, "METEOR": 0.306, "ROUGE_L": 0.611,
    "CIDEr": 1.437, "SPICE": 0.247,
}

# reference benchmarking/plotting.py:3-30 — VizWiz-val, baseline fork variant
VIZWIZ_VAL_BASELINE = {
    "Bleu_1": 0.6192, "Bleu_4": 0.1967, "ROUGE_L": 0.4272, "CIDEr": 0.4286,
    "SPICE": 0.1161, "METEOR": 0.1804,
}


def plot_comparison(
    measured_images_per_sec: float,
    out_path: str,
    measured_label: str = "this framework (TPU)",
    baseline_variant: str = "baseline",
) -> None:
    """Bar chart: reference latency-derived throughput vs a new measurement."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names, values = [], []
    for variant, lat in LATENCY_S.items():
        if variant.endswith("_set_b"):
            continue
        names.append(f"reference {variant}")
        values.append(1.0 / lat)
    names.append(measured_label)
    values.append(measured_images_per_sec)

    fig, ax = plt.subplots(figsize=(7, 4))
    bars = ax.bar(range(len(values)), values)
    bars[-1].set_color("tab:green")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=20, ha="right", fontsize=8)
    ax.set_ylabel("images / sec")
    ax.set_yscale("log")
    for i, v in enumerate(values):
        ax.text(i, v, f"{v:.2f}", ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)


def scores_table(measured: Dict[str, float], reference: Optional[Dict] = None) -> str:
    """Side-by-side metric table (reference defaults to the Karpathy single-model
    row — the rf_model.pth target)."""
    reference = reference or KARPATHY_TEST_SINGLE
    lines = [f"{'metric':<10} {'reference':>10} {'measured':>10}"]
    for k, ref_v in reference.items():
        got = measured.get(k)
        lines.append(
            f"{k:<10} {ref_v:>10.4f} {got if got is None else format(got, '>10.4f')}"
        )
    return "\n".join(lines)
