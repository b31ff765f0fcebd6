"""The benchmarking CLI (`cli/benchmark.py`) on the CPU, on a small
configuration through `run(args, cfg)` with `--device cpu`, against the JAX
package's CLI and modules: its flags and JSON keys, the parameter count and
FLOPs of `deploy/analysis.py`, the global sparsity after pruning rounds of
the same weights (carried across by the converter), the latency keys, int8,
the trace and the plot; and the refusal of a missing card."""
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import sys
from unittest import mock

import pytest
import torch

from on_device_image_captioning_torch.cli import benchmark as pbench
from on_device_image_captioning_torch.params.convert import state_dict_from_jax
from on_device_image_captioning_tpu.cli import benchmark as jbench
from on_device_image_captioning_tpu.deploy import analysis as ja
from on_device_image_captioning_tpu.deploy import pruning as jpruning

from test_torch_harness import REPO, TINY_E2E, e2e_pair, numpy_tree, to_jax_model

# the CLI's default backbone path at a size with no single-window stage
CFG = dataclasses.replace(
    TINY_E2E,
    swin=dataclasses.replace(TINY_E2E.swin, img_size=64, attention_impl="fused"),
    captioner=dataclasses.replace(TINY_E2E.captioner, vocab_size=50),
)
BASE = ["--device", "cpu", "--batch_size", "2", "--beam_size", "2", "--max_seq_len", "8"]
LATENCY_KEYS = {"mean", "p50", "p90", "min"}


def _run(argv, cfg=CFG):
    """run() with stdout captured: (results, the printed text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = pbench.run(pbench.parse_args(argv), cfg)
    return res, out.getvalue()


def _printed_json(text):
    return json.loads(text[text.index("{\n"):])


def _jax_result_keys():
    """The keys the JAX CLI writes into its results, read from its source."""
    src = open(jbench.__file__).read()
    literal = src[src.index("results = {"):src.index("}", src.index("results = {"))]
    return set(re.findall(r'"(\w+)":', literal)) | set(re.findall(r'results\["(\w+)"\] =', src))


def _options(parser_help):
    return set(re.findall(r"(--\w+)", parser_help))


def test_flags_are_the_jax_cli_s():
    """The JAX CLI's flags, with its backbone and step switches under the
    names of the port's other CLIs, plus --device; the JAX defaults."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        jbench.main(["--help"])
    jax_flags = _options(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        pbench.parse_args(["--help"])
    port_flags = _options(out.getvalue())
    assert jax_flags - port_flags == {"--attention_impl", "--dyn_step_impl"}
    assert port_flags - jax_flags == {"--swin_attention_impl", "--step_impl", "--device"}
    a = pbench.parse_args([])
    assert (a.load_path, a.batch_size, a.beam_size, a.max_seq_len, a.runs, a.param_config,
            a.prune_rounds, a.prune_amount, a.quantize, a.plot, a.trace, a.bf16) == (
        None, 1, 5, 20, 100, 0, 0, 0.33, "none", None, None, True)
    assert (a.swin_attention_impl, a.step_impl, a.device) == ("fused", "pallas", "cuda")
    assert not pbench.parse_args(["--fp32"]).bf16


def test_main_configuration_is_swin_l_d512_cut_by_param_config():
    a = pbench.parse_args(["--fp32", "--param_config", "2", "--swin_attention_impl", "pallas"])
    cfg = pbench.model_config(a)
    assert cfg.compute_dtype == torch.float32 and cfg.swin.attention_impl == "pallas"
    assert (cfg.swin.img_size, cfg.swin.embed_dim, cfg.swin.depths) == (384, 192, (2, 2, 18, 2))
    assert (cfg.captioner.d_model, cfg.captioner.N_enc, cfg.captioner.N_dec,
            cfg.captioner.vocab_size) == (512, 2, 2, 10000)
    cfg = pbench.model_config(pbench.parse_args([]))
    assert cfg.compute_dtype == torch.bfloat16 and cfg.swin.attention_impl == "fused"
    assert (cfg.captioner.N_enc, cfg.captioner.N_dec) == (3, 3)


@pytest.mark.parametrize("step_impl", ["pallas", "pallas_fused"])
def test_counts_flops_and_keys_equal_jax(step_impl):
    """params, flops and flops_reference_strategy equal the JAX
    `deploy/analysis.py` numbers for the same configuration and weights; the
    printed JSON is the returned one, with the JAX CLI's keys; the latency
    figures are finite and positive."""
    res, text = _run(BASE + ["--runs", "3", "--step_impl", step_impl])
    params, _ = e2e_pair(CFG, 0)
    jc = to_jax_model(CFG)
    assert res["params"] == ja.param_count(params)
    assert res["flops"] == ja.beam_search_flops(jc, 2, 8)
    assert res["flops_reference_strategy"] == ja.beam_search_flops(
        jc, 2, 8, incremental=False)["total"]
    assert _printed_json(text) == res
    assert set(res) == _jax_result_keys() - {"global_sparsity", "quantized"}
    assert set(res["latency_s"]) == LATENCY_KEYS
    for v in (*res["latency_s"].values(), res["images_per_sec"]):
        assert math.isfinite(v) and v > 0
    assert res["latency_s"]["min"] <= res["latency_s"]["p50"] <= res["latency_s"]["p90"]
    assert res["images_per_sec"] == pytest.approx(2 / res["latency_s"]["p50"])


def test_prune_rounds_give_the_jax_global_sparsity(tmp_path):
    """Two rounds at 0.33 over JAX weights carried into a `.pth` by the
    converter: the JAX `global_l1_prune`'s global sparsity, printed a round
    at a time."""
    params, _ = e2e_pair(CFG, 4)
    path = str(tmp_path / "model.pth")
    torch.save(state_dict_from_jax(numpy_tree(params), CFG), path)
    res, text = _run(BASE + ["--runs", "1", "--load_path", path, "--prune_rounds", "2"])
    want = []
    pruned = params
    for _ in range(2):
        pruned = jpruning.global_l1_prune(pruned, 0.33)
        want.append(jpruning.sparsity_report(pruned)["GLOBAL"])
    assert res["global_sparsity"] == want[-1]
    assert [float(x) for x in re.findall(r"prune round \d: global sparsity ([\d.]+)", text)] == [
        round(w, 3) for w in want]
    assert res["params"] == ja.param_count(params)
    assert set(res) == _jax_result_keys() - {"quantized"}


def test_quantized_trace_and_plot(tmp_path):
    """--quantize w8a8 runs the int8 model; --trace writes a trace and --plot
    a picture."""
    trace_dir, png = str(tmp_path / "trace"), str(tmp_path / "latency.png")
    res, text = _run(BASE + ["--runs", "2", "--quantize", "w8a8", "--trace", trace_dir,
                             "--plot", png])
    assert res["quantized"] == "w8a8"
    assert set(res) == _jax_result_keys() - {"global_sparsity"}
    assert any(f.endswith(".json") for f in os.listdir(trace_dir))
    assert os.path.getsize(png) > 0
    assert f"trace written to {trace_dir}" in text and f"plot saved to {png}" in text


def test_plot_without_matplotlib_fails():
    """--plot imports matplotlib only when asked, and fails where it is
    missing instead of skipping the plot."""
    with mock.patch.dict(sys.modules, {"matplotlib": None}), pytest.raises(ImportError):
        _run(BASE + ["--runs", "1", "--plot", "x.png"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present")
def test_refuses_a_missing_card():
    """Without --device cpu the CLI wants a card, and raises without one
    (before building the full-size model)."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pbench.main(["--runs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pbench.run(pbench.parse_args(["--runs", "1"]), CFG)


def test_module_runs_as_a_script():
    """`python -m on_device_image_captioning_torch.cli.benchmark --help`."""
    import subprocess

    out = subprocess.run([sys.executable, "-m", "on_device_image_captioning_torch.cli.benchmark",
                          "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--swin_attention_impl" in out.stdout
