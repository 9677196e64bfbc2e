"""
Build the GloVe embedding cache of a MART vocabulary:

    python -m coot_videotext_tpu_torch.mart_build_vocab \\
        {youcook2,activitynet} [--raw_glove_path data/glove.6B.300d.txt] \\
        [--annotations_dir annotations] [--cache_dir cache_caption]

looks up each word of <annotations_dir>/<dset>/mart_word2idx.json in a raw
GloVe txt file and stores the (vocab_size, 300) matrix as
<cache_dir>/<dset>_vocab_glove.pt, the file the caption trainer reads.

Port of mart_build_vocab.py at the repo root (reference
mart_build_vocab.py) on the port's data/caption_dataset.py. As in the
reference, the word2idx files shipped in annotations/ are frozen (a
rebuild from the captions gives another word order), so only the GloVe
extraction runs from the command line; `build_vocab_idx` builds a
compatible vocabulary for a new dataset. Pure Python: no device.
"""

import argparse
import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from coot_videotext_tpu_torch.data.caption_dataset import (
    BOS_TOKEN, CLS_TOKEN, EOS_TOKEN, PAD_TOKEN, SEP_TOKEN, UNK_TOKEN,
    VID_TOKEN, word_tokenize)


def load_glove(filename) -> Dict[str, np.ndarray]:
    """word -> vector of a raw GloVe txt file (reference :32)."""
    glove = {}
    with open(filename, encoding="utf-8") as f:
        for line in f.readlines():
            values = line.strip("\n").split(" ")
            glove[values[0]] = np.asarray(
                [float(e) for e in values[1:]])
    return glove


def extract_glove(word2idx: Dict[str, int], raw_glove_path: str,
                  vocab_glove_path: str, glove_dim: int = 300) -> None:
    """GloVe lookup for each vocab word (reference :47-70). Words not in
    GloVe get random-normal vectors (numpy's global generator), as in the
    reference."""
    print(f"Loading glove embedding at path: {raw_glove_path}.")
    glove_full = load_glove(raw_glove_path)
    print("Glove loaded, building vocab matrix.")
    idx2word = {int(i): w for w, i in word2idx.items()}
    vocab_size = len(idx2word)
    glove_matrix = np.zeros((vocab_size, glove_dim), np.float32)
    missing = 0
    for i in range(vocab_size):
        w = idx2word[i]
        if w in glove_full:
            glove_matrix[i] = glove_full[w]
        else:
            glove_matrix[i] = np.random.randn(glove_dim) * 0.4
            missing += 1
    print(f"Vocab embedding size {glove_matrix.shape}, "
          f"{missing} words missing from GloVe.")
    torch.save(glove_matrix, vocab_glove_path)
    print(f"Saved to {vocab_glove_path}")


def build_vocab_idx(annotations_file: str, min_word_count: int = 3
                    ) -> Dict[str, int]:
    """Word2idx for a new dataset: the special tokens at ids 0-6, then the
    words of the captions seen at least `min_word_count` times, sorted
    (reference _unused_build_vocab_idx)."""
    data = json.loads(Path(annotations_file).read_text(encoding="utf8"))
    counter: Counter = Counter()
    for item in data.values():
        for sen in item["sentences"]:
            counter.update(word_tokenize(sen.lower()))
    word2idx = {PAD_TOKEN: 0, CLS_TOKEN: 1, SEP_TOKEN: 2, VID_TOKEN: 3,
                BOS_TOKEN: 4, EOS_TOKEN: 5, UNK_TOKEN: 6}
    for word, count in sorted(counter.items()):
        if count >= min_word_count and word not in word2idx:
            word2idx[word] = len(word2idx)
    return word2idx


def main(argv: Optional[List[str]] = None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dset_name", type=str,
                        choices=["activitynet", "youcook2"])
    parser.add_argument("--raw_glove_path", type=str,
                        default="data/glove.6B.300d.txt")
    parser.add_argument("--annotations_dir", type=str,
                        default="annotations")
    parser.add_argument("--cache_dir", type=str, default="cache_caption")
    args = parser.parse_args(argv)

    word2idx_file = (Path(args.annotations_dir) / args.dset_name /
                     "mart_word2idx.json")
    word2idx = json.loads(word2idx_file.read_text(encoding="utf8"))
    print(f"WORD2IDX: {word2idx_file} len {len(word2idx)}")
    Path(args.cache_dir).mkdir(parents=True, exist_ok=True)
    vocab_glove_path = (Path(args.cache_dir) /
                        f"{args.dset_name}_vocab_glove.pt")
    extract_glove(word2idx, args.raw_glove_path, str(vocab_glove_path))
    return vocab_glove_path


if __name__ == "__main__":
    main()
