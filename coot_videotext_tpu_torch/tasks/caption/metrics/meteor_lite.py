"""
Copy of coot_videotext_tpu/tasks/caption/metrics/meteor_lite.py with its
own Porter stemmer (metrics/porter.py) in place of nltk's.

Hermetic METEOR ("METEOR-lite"): the Banerjee & Lavie 2005 algorithm in
pure Python — no JVM, no resource files.

The reference scores captions with the METEOR 1.5 Java jar
(mart/evaluate_language.py:63-78); on a machine without a JVM the jar
path (metrics/meteor.py, kept primary) can never produce a number and the
reference semantics would leave every METEOR at -999.
METEOR-lite restores a real METEOR number while staying honest about
what it is:

  - matcher stages: exact unigram match, then Porter-stem match on the
    leftovers (the Porter stemmer with nltk's extensions, copied into
    metrics/porter.py; no corpus downloads).
    The 1.5 jar additionally has WordNet-synonym + paraphrase-table
    stages and a function-word discount, all of which need resource
    files — omitted.
  - alignment: with equal module weights (lite, like nltk, weighs the
    exact and stem stages identically) surface equality implies stem
    equality, so the two-stage match relation collapses to STEM
    equality alone: the match cardinality is
    sum over stem types of min(hyp count, ref count) — fixed
    regardless of pairing, and exactly the total the sequential
    exact-then-stem staging yields. Among the maximum matchings a
    bounded beam search picks the pairing that minimizes the number of
    chunks, as the paper specifies (the published METEOR aligner runs
    the same kind of search).
  - score: P = m/|hyp|, R = m/|ref|,
    Fmean = P*R / (alpha*P + (1-alpha)*R),
    Penalty = gamma * (chunks/m)**beta, score = Fmean * (1 - Penalty),
    with the 2005/nltk English defaults alpha=0.9, beta=3, gamma=0.5.
    Corpus-level score = mean of segment scores, the same aggregation
    the jar's -stdio protocol consumer applies in evaluate_language.py.

The JAX package's golden tests (tests/test_meteor_lite.py) pin it;
tests/test_torch_caption_metrics.py holds this copy equal to it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from coot_videotext_tpu_torch.tasks.caption.metrics.porter import (
    PorterStemmer)

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5
_BEAM = 64

_stemmer = PorterStemmer()
_stem_cache: Dict[str, str] = {}


def _stem(word: str) -> str:
    s = _stem_cache.get(word)
    if s is None:
        s = _stemmer.stem(word)
        _stem_cache[word] = s
    return s


def _align(hyp_words: List[str], ref_words: List[str]) -> Tuple[int, int]:
    """(matches, chunks) for the stem-equality match relation (= the
    exact+stem staging at equal weights; see module docstring) with a
    chunk-minimizing beam search over the maximum matchings."""
    hyp_stems = [_stem(w) for w in hyp_words]
    ref_stems = [_stem(w) for w in ref_words]
    ref_by_stem: Dict[str, List[int]] = {}
    for j, s in enumerate(ref_stems):
        ref_by_stem.setdefault(s, []).append(j)
    hyp_by_stem: Dict[str, List[int]] = {}
    for i, s in enumerate(hyp_stems):
        hyp_by_stem.setdefault(s, []).append(i)

    cands: Dict[int, Tuple[int, ...]] = {}
    matches = 0
    for stem_type, his in hyp_by_stem.items():
        rjs = ref_by_stem.get(stem_type)
        if not rjs:
            continue
        matches += min(len(his), len(rjs))
        for i in his:
            cands[i] = tuple(rjs)
    if matches == 0:
        return 0, 0

    # Beam over participating hyp positions in order. State key:
    # (last_hyp, last_ref, used_refs); value: (chunks, n_matched). A
    # chunk continues only when both sides are adjacent to the previous
    # match. The per-stem-type cardinality bound is enforced by ref
    # bookkeeping (each ref position used once) plus the
    # leave-unmatched branch; the final answer is the fewest chunks
    # among states that reached the maximum cardinality.
    states: Dict[Tuple[int, int, frozenset], Tuple[int, int]] = {
        (-9, -9, frozenset()): (0, 0)}
    for i in sorted(cands.keys()):
        nxt: Dict[Tuple[int, int, frozenset], Tuple[int, int]] = {}

        def push(key, val):
            old = nxt.get(key)
            if old is None or val < old:
                nxt[key] = val

        for (lh, lr, used), (ch, nm) in states.items():
            push((lh, lr, used), (ch, nm))  # leave i unmatched
            for j in cands[i]:
                if j in used:
                    continue
                cont = (j == lr + 1 and i == lh + 1)
                push((i, j, used | {j}),
                     (ch + (0 if cont else 1), nm + 1))
        ranked = sorted(nxt.items(),
                        key=lambda kv: (-kv[1][1], kv[1][0]))[:_BEAM]
        states = dict(ranked)

    full = [ch for (_lh, _lr, _u), (ch, nm) in states.items()
            if nm == matches]
    if full:
        return matches, min(full)
    # beam dropped every maximum matching (adversarial repetition); use
    # the best retained state so the score stays well-defined
    nm_best = max(nm for _k, (ch, nm) in states.items())
    ch_best = min(ch for _k, (ch, nm) in states.items() if nm == nm_best)
    return nm_best, ch_best


def sentence_score(hypothesis: Sequence[str],
                   reference: Sequence[str]) -> float:
    """METEOR-lite segment score for a tokenized hyp vs ONE reference."""
    hyp = list(hypothesis)
    ref = list(reference)
    if not hyp or not ref:
        return 0.0
    m, ch = _align(hyp, ref)
    if m == 0:
        return 0.0
    p = m / len(hyp)
    r = m / len(ref)
    fmean = (p * r) / (ALPHA * p + (1 - ALPHA) * r)
    penalty = GAMMA * (ch / m) ** BETA
    return fmean * (1.0 - penalty)


class MeteorLite:
    """pycocoevalcap-compatible scorer interface (compute_score), scoring
    with the hermetic Python METEOR above. Multiple references per
    segment take the best-scoring reference, as METEOR does."""

    @staticmethod
    def method() -> str:
        return "METEOR"

    def compute_score(self, gts, res) -> Tuple[float, List[float]]:
        assert gts.keys() == res.keys()
        scores: List[float] = []
        for idx in gts.keys():
            assert len(res[idx]) == 1
            hyp = res[idx][0].split()
            segment = 0.0
            for ref in gts[idx]:
                segment = max(segment, sentence_score(hyp, ref.split()))
            scores.append(segment)
        final = sum(scores) / len(scores) if scores else 0.0
        return final, scores

    def close(self) -> None:  # scorer-interface parity with Meteor
        pass
