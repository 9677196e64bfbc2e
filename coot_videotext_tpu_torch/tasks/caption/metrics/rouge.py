"""
Copy of coot_videotext_tpu/tasks/caption/metrics/rouge.py (pure Python; the
port keeps its own copy so it never imports the JAX package).

ROUGE-L (Lin 2004), algorithm-compatible with pycocoevalcap's Rouge:
per sample the max over references of the LCS-based F-measure with
beta = 1.2; corpus score is the mean.
"""

from __future__ import annotations

from typing import List, Tuple


def _lcs_len(a: List[str], b: List[str]) -> int:
    """Length of the longest common subsequence (O(len(a)*len(b)))."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            if x == y:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(cur[j - 1], prev[j])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2) -> None:
        self.beta = beta

    def method(self) -> str:
        return "Rouge"

    def calc_score(self, candidate: List[str],
                   refs: List[str]) -> float:
        assert len(candidate) == 1 and len(refs) >= 1
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref in refs:
            ref_words = ref.split()
            lcs = _lcs_len(hyp, ref_words)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(ref_words) if ref_words else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            return ((1 + self.beta ** 2) * p * r) / (
                r + self.beta ** 2 * p)
        return 0.0

    def compute_score(self, gts, res) -> Tuple[float, List[float]]:
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[idx], gts[idx]) for idx in gts]
        import numpy as np
        return float(np.mean(scores)), scores
