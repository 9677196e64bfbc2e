"""
Copy of coot_videotext_tpu/tasks/caption/metrics/meteor.py (pure Python; the
port keeps its own copy so it never imports the JAX package).

METEOR: Java-subprocess scorer wrapper with the reference's crash
semantics. The reference runs pycocoevalcap's METEOR 1.5 jar; when Java or
the jar is missing the scorer is treated as crashed-at-startup and every
METEOR score is reported as -999 (mart/evaluate_language.py:63-68 and
:168-182), keeping metric-file schemas intact.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

METEOR_JAR_ENV = "METEOR_JAR"


class Meteor:
    """Minimal pycocoevalcap-compatible METEOR subprocess wrapper."""

    def __init__(self, jar_path: str) -> None:
        self.jar_path = jar_path
        self.lock = threading.Lock()
        self.process = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", jar_path, "-", "-", "-stdio",
             "-l", "en", "-norm"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            universal_newlines=True, bufsize=1)

    def method(self) -> str:
        return "METEOR"

    def compute_score(self, gts, res) -> Tuple[float, List[float]]:
        assert gts.keys() == res.keys()
        ids = list(gts.keys())
        scores = []
        with self.lock:
            eval_line = "EVAL"
            for idx in ids:
                assert len(res[idx]) == 1
                stat = self._stat(res[idx][0], gts[idx])
                eval_line += f" ||| {stat}"
            self.process.stdin.write(eval_line + "\n")
            for _ in ids:
                scores.append(float(self.process.stdout.readline().strip()))
            final = float(self.process.stdout.readline().strip())
        return final, scores

    def _stat(self, hypothesis: str, references: List[str]) -> str:
        hypothesis = hypothesis.replace("|||", "").replace("  ", " ")
        score_line = " ||| ".join(
            ("SCORE", " ||| ".join(references), hypothesis))
        self.process.stdin.write(score_line + "\n")
        return self.process.stdout.readline().strip()

    def close(self) -> None:
        with self.lock:
            if self.process:
                self.process.stdin.close()
                self.process.kill()
                self.process.wait()


def find_meteor_jar() -> Optional[str]:
    """Locate a METEOR jar: $METEOR_JAR, or pycocoevalcap if installed."""
    jar = os.environ.get(METEOR_JAR_ENV)
    if jar and os.path.isfile(jar):
        return jar
    try:
        import pycocoevalcap.meteor as m
        jar = os.path.join(os.path.dirname(m.__file__),
                           "meteor-1.5.jar")
        if os.path.isfile(jar):
            return jar
    except ImportError:
        pass
    return None


def make_meteor() -> Optional[Meteor]:
    """Meteor instance or None (-999 semantics) when unavailable."""
    if shutil.which("java") is None:
        return None
    jar = find_meteor_jar()
    if jar is None:
        return None
    try:
        return Meteor(jar)
    except (OSError, FileNotFoundError, AttributeError):
        return None
