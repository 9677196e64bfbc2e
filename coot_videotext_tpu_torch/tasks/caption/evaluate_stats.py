"""
Vocabulary-size / sentence-length statistics.

Copy of coot_videotext_tpu/tasks/caption/evaluate_stats.py (reference
mart/evaluate_stats.py:20-71); sentences are tokenized by the port's copy
of the Treebank word tokenizer (data/caption_dataset.py).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from coot_videotext_tpu_torch.data.caption_dataset import word_tokenize


def get_sen_stat(list_of_str: List[str]) -> Dict[str, Any]:
    """(reference :28)."""
    tokenized = [word_tokenize(sen.lower()) for sen in list_of_str]
    lengths = [len(e) for e in tokenized]
    full_vocab = {tok for sent in tokenized for tok in sent}
    return {"vocab_size": len(full_vocab),
            "avg_sen_len": 1.0 * sum(lengths) / max(len(lengths), 1),
            "num_sen": len(list_of_str)}


def evaluate_stats_files(submission_file, reference_file,
                         output_file: Optional[Union[str, Path]] = None,
                         verbose: bool = False) -> Dict[str, Any]:
    """(reference :41)."""
    sub_data = json.loads(Path(submission_file).read_text(encoding="utf8"))
    ref_data = json.loads(Path(reference_file).read_text(encoding="utf8"))
    sub_data = sub_data.get("results", sub_data)
    ref_data = ref_data.get("results", ref_data)
    sub_data = {k: v for k, v in sub_data.items() if k in ref_data}

    entries = [item for sublist in sub_data.values() for item in sublist]
    submission_stat = get_sen_stat([e["sentence"] for e in entries])
    final_res = {"submission": submission_stat}
    if entries and "gt_sentence" in entries[0]:
        final_res["gt_stat"] = get_sen_stat(
            [e["gt_sentence"] for e in entries])
    if output_file is not None:
        Path(output_file).write_text(
            json.dumps(final_res, indent=4, sort_keys=True),
            encoding="utf8")
    return final_res
