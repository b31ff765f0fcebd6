"""METEOR scorer — optional external-tool wrapper.

A copy of the JAX package's `evalcap/meteor.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package.

The reference runs meteor-1.5.jar over a stdin/stdout pipe (reference
eval/meteor/meteor.py:25-111); the jar is not shipped in the snapshot
(.MISSING_LARGE_BLOBS). This wrapper activates when METEOR_JAR points at a jar
(same EVAL/SCORE line protocol); otherwise it raises with guidance, keeping
METEOR strictly opt-in like the reference's own evaluate(meteor=...) flag.
"""
from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List, Tuple

import numpy as np


class MeteorScorer:
    def __init__(self, jar_path: str | None = None):
        self.jar = jar_path or os.environ.get("METEOR_JAR")
        if not self.jar or not os.path.exists(self.jar):
            raise RuntimeError(
                "METEOR requires meteor-1.5.jar (set METEOR_JAR); the jar is an "
                "external Java tool not bundled with this framework"
            )
        self._lock = threading.Lock()
        self._proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", self.jar, "-", "-", "-stdio", "-l", "en",
             "-norm"],
            cwd=os.path.dirname(self.jar),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            text=True,
            bufsize=1,
        )

    def compute(
        self, gts: Dict[object, List[str]], res: Dict[object, List[str]]
    ) -> Tuple[float, np.ndarray]:
        img_ids = list(gts.keys())
        with self._lock:
            eval_line = "EVAL"
            for i in img_ids:
                stat = self._stat(res[i][0], gts[i])
                eval_line += " ||| " + stat
            self._proc.stdin.write(eval_line + "\n")
            scores = [float(self._proc.stdout.readline().strip()) for _ in img_ids]
            final = float(self._proc.stdout.readline().strip())
        return final, np.asarray(scores)

    def _stat(self, hypothesis: str, references: List[str]) -> str:
        hypothesis = hypothesis.replace("|||", "").replace("  ", " ")
        line = " ||| ".join(("SCORE", " ||| ".join(references), hypothesis))
        self._proc.stdin.write(line + "\n")
        return self._proc.stdout.readline().strip()

    def close(self):
        with self._lock:
            if self._proc:
                self._proc.stdin.close()
                self._proc.kill()
                self._proc.wait()
                self._proc = None
