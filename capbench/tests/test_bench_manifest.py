"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from capbench.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest(ROOT)


def test_top_level_keys(manifest):
    d = manifest.data
    assert set(d) == TOP_KEYS
    assert 1 <= d["run_seconds"] <= 51 and isinstance(d["run_seconds"], int)
    assert len(json.dumps(d)) < 64 * 1024
    for path in d["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
    assert all("/" not in w or w.startswith(tuple(d["paths"])) for w in d["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(manifest, section):
    entries = manifest.data[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_every_file_found_by_name(manifest):
    for c in manifest.data["configs"]:
        cfg = manifest.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("capbench/")
    for w in manifest.data["workloads"]:
        traffic = manifest.traffic(w["traffic"])
        assert manifest.entry_class(traffic["entry"]) is not None
        assert w["chips"] == 1
    for m in manifest.data["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_every_cell_reports_enough(manifest):
    e2e = {m["name"] for m in manifest.data["end_to_end"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in manifest.data["end_to_end"])
    for m in manifest.data["per_layer"]:
        assert m["moves"] in e2e
    for w in manifest.data["workloads"]:
        reported = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        for m in manifest.per_layer(w["name"]):
            assert m["moves"] in reported
        assert manifest.per_layer(w["name"])


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A configuration, a traffic mix with its cell and a per-layer metric
    added as new files (and lines of BENCHMARK.json) are found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "capbench", root / "capbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "capbench/configs/expv2_swinL384_serve_bf16.json").read_text())
    cfg["name"] = "expv2_swinL384_serve_fp32"
    cfg["compute_dtype"] = "float32"
    (root / "capbench/configs/expv2_swinL384_serve_fp32.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "capbench/traffic/batch32_beam3_L20.json").read_text())
    traffic["batch"] = 8
    (root / "capbench/traffic/batch8_beam3_L20.json").write_text(json.dumps(traffic))
    (root / "capbench/metrics/decode_share.serve.py").write_text(
        "def read(view):\n    return 42.0\n")
    data["configs"].append({"name": cfg["name"], "source": "s", "why": "w",
                            "file": "capbench/configs/expv2_swinL384_serve_fp32.json",
                            "reduced": []})
    data["workloads"].append({"name": "serve_fp32_b8", "config": cfg["name"],
                              "traffic": "batch8_beam3_L20", "chips": 1, "why": "w"})
    data["end_to_end"][0]["workloads"].append("serve_fp32_b8")
    data["per_layer"].append({"name": "decode_share.serve", "unit": "%", "better": "lower",
                              "source": "program_span", "layer": "decode",
                              "moves": "captions_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    m = Manifest(root)
    assert m.config("expv2_swinL384_serve_fp32")["compute_dtype"] == "float32"
    assert m.traffic(m.workload("serve_fp32_b8")["traffic"])["batch"] == 8
    assert "decode_share.serve" in [x["name"] for x in m.per_layer("serve_fp32_b8")]
    assert "decode_share.serve" in [x["name"] for x in m.per_layer("serve_b32_beam3_L20")]
    assert m.reader("decode_share.serve")(None) == 42.0


def test_refuses_without_a_card_or_without_the_program(tmp_path):
    """With only BENCHMARK.json and capbench/ the run prints no result and
    exits non-zero (here: no card)."""
    shutil.copytree(ROOT / "capbench", tmp_path / "capbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "capbench.run", "--workload",
                          "serve_b32_beam3_L20", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
