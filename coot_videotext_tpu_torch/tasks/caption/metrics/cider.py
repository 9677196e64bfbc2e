"""
Copy of coot_videotext_tpu/tasks/caption/metrics/cider.py (pure Python; the
port keeps its own copy so it never imports the JAX package).

CIDEr-D (Vedantam et al. 2015), algorithm-compatible with pycocoevalcap's
Cider/CiderScorer: tf-idf over 1..4-grams with document frequency from the
reference corpus, cosine similarity with length-difference gaussian
penalty (sigma = 6) and count clipping, averaged over n and references,
scaled by 10.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _ngrams(words: List[str], n: int = 4) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0) -> None:
        self.n = n
        self.sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def compute_score(self, gts, res) -> Tuple[float, List[float]]:
        assert gts.keys() == res.keys()
        ids = list(gts.keys())
        crefs = [[_ngrams(r.split(), self.n) for r in gts[idx]]
                 for idx in ids]
        ctest = [_ngrams(res[idx][0].split(), self.n) for idx in ids]

        # document frequency over reference sets
        doc_freq: Dict[tuple, int] = defaultdict(int)
        for refs in crefs:
            for ng in set(ng for ref in refs for ng in ref):
                doc_freq[ng] += 1
        log_n_docs = math.log(max(len(crefs), 1))

        def vectorize(counts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ng, cnt in counts.items():
                df = math.log(max(doc_freq[ng], 1.0))
                k = len(ng) - 1
                vec[k][ng] = cnt * (log_n_docs - df)
                norm[k] += vec[k][ng] ** 2
                if k == 0:
                    length += cnt
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r):
            delta = float(len_h - len_r)
            val = np.zeros(self.n)
            for k in range(self.n):
                for ng, w in vec_h[k].items():
                    # CIDEr-D count clipping: min(hyp, ref) weight
                    val[k] += min(w, vec_r[k].get(ng, 0.0)) * \
                        vec_r[k].get(ng, 0.0)
                if norm_h[k] and norm_r[k]:
                    val[k] /= norm_h[k] * norm_r[k]
                val[k] *= np.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vec_h, norm_h, len_h = vectorize(test)
            score = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, len_r = vectorize(ref)
                score += sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r)
            score_avg = np.mean(score / max(len(refs), 1)) * 10.0
            scores.append(float(score_avg))
        return float(np.mean(scores)) if scores else 0.0, scores
