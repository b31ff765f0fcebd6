"""SPICE scorer — optional external-tool wrapper.

A copy of the JAX package's `evalcap/spice.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

The reference writes a JSON batch to a temp file and runs spice-1.0.jar
(reference eval/spice/spice.py:18-126); the jar and its CoreNLP models are
external binaries absent from the snapshot. Activates when SPICE_JAR is set,
mirroring the same temp-file JSON protocol; otherwise raises, keeping SPICE
opt-in like the reference's evaluate(spice=...) flag.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Dict, List, Tuple

import numpy as np


class SpiceScorer:
    def __init__(self, jar_path: str | None = None):
        self.jar = jar_path or os.environ.get("SPICE_JAR")
        if not self.jar or not os.path.exists(self.jar):
            raise RuntimeError(
                "SPICE requires spice-1.0.jar (set SPICE_JAR); the jar is an "
                "external Java tool not bundled with this framework"
            )

    def compute(
        self, gts: Dict[object, List[str]], res: Dict[object, List[str]]
    ) -> Tuple[float, np.ndarray]:
        img_ids = list(gts.keys())
        payload = [
            {"image_id": str(i), "test": res[i][0], "refs": gts[i]} for i in img_ids
        ]
        workdir = os.path.dirname(self.jar)
        cache = os.path.join(workdir, "cache")
        os.makedirs(cache, exist_ok=True)
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as fin:
            json.dump(payload, fin)
            in_path = fin.name
        out_path = in_path + ".out"
        try:
            subprocess.check_call(
                ["java", "-jar", "-Xmx8G", self.jar, in_path, "-cache", cache,
                 "-out", out_path, "-subset", "-silent"],
                cwd=workdir,
            )
            with open(out_path) as f:
                results = json.load(f)
        finally:
            for p in (in_path, out_path):
                if os.path.exists(p):
                    os.remove(p)
        by_id = {r["image_id"]: r["scores"]["All"]["f"] for r in results}
        scores = np.asarray(
            [float(np.nan_to_num(by_id[str(i)])) for i in img_ids]
        )
        return float(scores.mean()), scores
