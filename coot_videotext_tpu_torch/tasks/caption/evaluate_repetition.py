"""
Copy of coot_videotext_tpu/tasks/caption/evaluate_repetition.py (pure
Python; the port keeps its own copy so it never imports the JAX package).

N-gram repetition metrics R@1-4 per video.

Behavioral port of reference mart/evaluate_repetition.py:28-153.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np


def get_ngrams(words_pred: List[str], unigrams: Counter, bigrams: Counter,
               trigrams: Counter, fourgrams: Counter):
    """Accumulate 1-4 gram counts (reference :28)."""
    for n, counter in ((1, unigrams), (2, bigrams), (3, trigrams),
                       (4, fourgrams)):
        for i in range(len(words_pred) - n + 1):
            counter["_".join(words_pred[i:i + n])] += 1
    return unigrams, bigrams, trigrams, fourgrams


def _clean_sentence(pred_sentence: str) -> str:
    """Sentence cleanup before n-gram counting (reference :90-99)."""
    if len(pred_sentence) > 0:
        if pred_sentence[-1] == ".":
            pred_sentence = pred_sentence[:-1]
        while pred_sentence and pred_sentence[-1] == " ":
            pred_sentence = pred_sentence[:-1]
        pred_sentence = pred_sentence.replace(",", " ")
    while "  " in pred_sentence:
        pred_sentence = pred_sentence.replace("  ", " ")
    return pred_sentence


def evaluate_repetition(data_predicted: Dict, data_gt: Dict,
                        verbose: bool = False) -> Dict:
    """Per-video repeat ratio, averaged (reference :64)."""
    num_pred = len(data_predicted)
    num_gt = len(data_gt)
    num_evaluated = 0
    re = {1: [], 2: [], 3: [], 4: []}
    for vid in data_gt:
        if vid not in data_predicted:
            continue
        num_evaluated += 1
        grams = [Counter() for _ in range(4)]
        for e in data_predicted[vid]:
            words = _clean_sentence(e["sentence"]).split(" ")
            get_ngrams(words, *grams)
        for n in range(1, 5):
            total = float(sum(grams[n - 1].values()))
            repeats = float(sum(max(c - 1, 0)
                                for c in grams[n - 1].values()))
            re[n].append(repeats / total if total != 0 else 0)
    return dict(
        re1=float(np.mean(re[1])), re2=float(np.mean(re[2])),
        re3=float(np.mean(re[3])), re4=float(np.mean(re[4])),
        num_pred=num_pred, num_gt=num_gt, num_evaluated=num_evaluated)


def evaluate_repetition_files(submission_file, reference_file,
                              output_file: Optional[Union[str, Path]] = None,
                              verbose: bool = False):
    """(reference :131)."""
    sub_data = json.loads(Path(submission_file).read_text(encoding="utf8"))
    ref_data = json.loads(Path(reference_file).read_text(encoding="utf8"))
    sub_data = sub_data.get("results", sub_data)
    ref_data = ref_data.get("results", ref_data)
    rep_scores = evaluate_repetition(sub_data, ref_data, verbose=verbose)
    if output_file is not None:
        Path(output_file).write_text(
            json.dumps(rep_scores, indent=4, sort_keys=True),
            encoding="utf8")
    return rep_scores
