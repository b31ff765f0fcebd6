"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: its `file` (a JSON dict of sizes, dtype and paths);
- a traffic mix: `capbench/traffic/<traffic>.json`, which names its entry;
- an entry: the module `capbench/entries/<entry>.py`, class `Entry`;
- a per-layer metric: the reader `capbench/metrics/<name>.py`, whose
  `read(view)` returns a number or None.

A later configuration, traffic mix or metric is a new file and a new entry
in `BENCHMARK.json`; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent


class Manifest:
    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.here = self.root / "capbench"

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def entry_class(self, entry: str):
        return importlib.import_module(f"capbench.entries.{entry}").Entry

    def end_to_end(self, cell: str) -> List[Dict]:
        """The end-to-end metrics the cell reports (setup_s included)."""
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics read in the cell: those listing it, and
        those without a list whose moved metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def reader(self, metric: str):
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "capbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
