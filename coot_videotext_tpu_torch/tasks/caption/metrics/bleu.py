"""
Copy of coot_videotext_tpu/tasks/caption/metrics/bleu.py (pure Python; the
port keeps its own copy so it never imports the JAX package).

Corpus BLEU, algorithm-compatible with pycocoevalcap's BleuScorer
(Papineni et al. 2002 with the standard smoothing constants and the
'closest' effective reference length, as selected by the reference's Bleu
wrapper, mart/evaluate_language.py:264).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

TINY = 1e-15
SMALL = 1e-9


def _ngram_counts(words: List[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class BleuScorer:
    """Accumulate (hypothesis, references) pairs; compute corpus BLEU-n."""

    def __init__(self, n: int = 4) -> None:
        self.n = n
        self.crefs: List[Tuple[List[int], Dict[tuple, int]]] = []
        self.ctest: List[Tuple[int, Dict[tuple, int]]] = []

    def append(self, hypothesis: str, references: List[str]) -> None:
        ref_lens = [len(r.split()) for r in references]
        ref_counts: Dict[tuple, int] = defaultdict(int)
        for ref in references:
            for ng, cnt in _ngram_counts(ref.split(), self.n).items():
                ref_counts[ng] = max(ref_counts[ng], cnt)
        self.crefs.append((ref_lens, ref_counts))
        words = hypothesis.split()
        self.ctest.append((len(words), _ngram_counts(words, self.n)))

    __iadd__ = None  # use append()

    @staticmethod
    def _closest_ref_len(ref_lens: List[int], test_len: int) -> int:
        return min(ref_lens, key=lambda rl: (abs(rl - test_len), rl))

    def _stats(self, test, refs):
        test_len, hyp_counts = test
        ref_lens, ref_counts = refs
        correct = [0] * self.n
        guess = [max(0, test_len - k) for k in range(self.n)]
        for ng, cnt in hyp_counts.items():
            correct[len(ng) - 1] += min(cnt, ref_counts.get(ng, 0))
        return test_len, self._closest_ref_len(ref_lens, test_len), \
            guess, correct

    @staticmethod
    def _bleu_from_totals(testlen, reflen, guess, correct, n):
        bleus = []
        bleu = 1.0
        for k in range(n):
            bleu *= (correct[k] + TINY) / (guess[k] + SMALL)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (testlen + TINY) / (reflen + SMALL)
        if ratio < 1:
            penalty = math.exp(1 - 1 / ratio)
            bleus = [b * penalty for b in bleus]
        return bleus

    def compute_score(self) -> Tuple[List[float], List[List[float]]]:
        """Returns ([bleu1..bleuN] corpus, per-sample list of the same)."""
        total_testlen = 0
        total_reflen = 0
        total_guess = [0] * self.n
        total_correct = [0] * self.n
        per_sample = []
        for test, refs in zip(self.ctest, self.crefs):
            testlen, reflen, guess, correct = self._stats(test, refs)
            total_testlen += testlen
            total_reflen += reflen
            for k in range(self.n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]
            per_sample.append(self._bleu_from_totals(
                testlen, reflen, guess, correct, self.n))
        corpus = self._bleu_from_totals(
            total_testlen, total_reflen, total_guess, total_correct,
            self.n)
        # transpose per-sample to [n][samples] (pycocoevalcap layout)
        per_n = [[s[k] for s in per_sample] for k in range(self.n)]
        return corpus, per_n


class Bleu:
    """compute_score(gts, res) facade (reference Bleu wrapper :236)."""

    def __init__(self, n: int = 4, verbose: int = 0) -> None:
        self._n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(self, gts, res):
        assert gts.keys() == res.keys()
        scorer = BleuScorer(n=self._n)
        for idx in gts:
            hypo = res[idx]
            ref = gts[idx]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(ref, list) and len(ref) >= 1
            scorer.append(hypo[0], ref)
        return scorer.compute_score()
