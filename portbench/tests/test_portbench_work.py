"""The operation and byte counts against hand counts at a tiny size."""

import pytest

from portbench import work

DIMS = {"d": 8, "ff": 4, "pool_hidden": 16, "pool_heads": 2, "vid_in": 10,
        "text_in": 6}
# two videos: frames 3 and 2, clips (2, 1) and (2), paragraphs of 4 and 2
# tokens in sentences (3, 1) and (2)
COUNTS = {"videos": 2, "vid_rows": 5, "vid_sq": 13, "clip_rows": 5,
          "clip_sq": 9, "par_rows": 6, "par_sq": 20, "sent_rows": 6,
          "sent_sq": 14, "clips": 3, "clips_sq": 5}


def test_coot_forward_by_hand():
    f = work.coot_forward_flops(COUNTS, DIMS)
    assert f["b1"] == 2 * 8 * (5 * 10 + 5 * 10 + 6 * 6 + 6 * 6)
    enc = lambda rows, sq: rows * (8 * 64 + 4 * 8 * 4) + 4 * sq * 8  # noqa
    pool = lambda rows: 2 * rows * (8 * 16 + 16 * 8 // 2)  # noqa
    local = sum(enc(r, s) + pool(r) for r, s in
                ((5, 13), (5, 9), (6, 20), (6, 14)))
    glob = 2 * (enc(3, 5) + 4 * 2 * 64 + 4 * 3 * 64 + 4 * 3 * 8
                + 4 * 2 * 8 * 4)
    assert f["rest"] == local + glob
    assert work.coot_train_flops(COUNTS, DIMS) == 2 * f["b1"] + 3 * f["rest"]
    assert work.coot_eval_flops(COUNTS, DIMS) == f["b1"] + f["rest"]


def test_bound_takes_the_longer_of_bytes_and_products():
    assert work.bound_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert work.bound_s(0, 67e12, "float32") == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 989e12 * 2, "bfloat16") == \
        pytest.approx(2.0)


def test_kernel_bound_grows_with_training_and_work():
    ev = work.coot_kernel_bound_s(COUNTS, DIMS, False)
    tr = work.coot_kernel_bound_s(COUNTS, DIMS, True)
    assert 0 < ev < tr
    double = {k: 2 * v for k, v in COUNTS.items()}
    # the weights are read once a call, whatever the rows
    assert tr < work.coot_kernel_bound_s(double, DIMS, True) < 2 * tr


def test_mart_sentence_by_hand():
    cfg = {"hidden_size": 4, "intermediate_size": 4, "vocab_size": 5,
           "word_vec_size": 3, "video_feature_size": 2, "n_memory_cells": 1,
           "max_v_len": 1, "max_t_len": 1, "num_hidden_layers": 1}
    d, length, prefix = 4, 2, 3
    emb = length * 2 * d * (3 + 2)
    layer = (length * (8 * 16 + 2 * 16 + 2 * 16) + 4 * d * prefix
             + 2 * 16 + length * 4 * 16 + 4 * d * length + 8 * 16
             + length * 8 * 16 + 4 * d * (prefix + length))
    head = length * (2 * 16 + 2 * d * 5)
    assert work.mart_sentence_flops(cfg) == emb + layer + head
