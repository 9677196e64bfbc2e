"""The Transformer-XL train cell (`kinds/caption_train_xl.py`) on the CPU
at its published widths on a small split: the program agrees with the
plain reference (`reference/xl.py`), the TF32 control and the planted
fault come out not correct; the traffic's rows follow the caption
dataset's mapping; `metrics/relattn_ms.py` reads its marks."""

import copy
import math
import time

import numpy as np
import pytest
import torch

from portbench import check, run
from portbench.kinds import caption_train_xl
from portbench.tests import tiny
from portbench.trace import Trace

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234567
CELL = "xl-yc2-raw.train"


def small():
    """The published widths on the first 12 videos in batches of 4, at
    most 4 sentence steps a video."""
    _, cfg, traffic, limits = run.load_cell(tiny.BENCH, CELL)
    cfg = dict(copy.deepcopy(cfg), max_n_sen=4)
    return dict(config=cfg, traffic=dict(
        traffic, batch_size=4, segments=traffic["segments"][:12],
        feature_rows=traffic["feature_rows"][:12]), limits=limits)


def _run(overrides):
    return run.execute(tiny.BENCH, CELL, SEED, 0.1, False, CPU, time.time(),
                       overrides=overrides)


def test_the_program_agrees_with_the_reference():
    res = _run(small())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_videos_per_s", "setup_s"}


def test_the_tf32_control_is_not_correct():
    o = small()
    cell = caption_train_xl.Cell(o["config"], o["traffic"], SEED, CPU)
    cell.free_program()
    ref = cell.reference("float32")
    numbers = cell.compare(cell.reference(cell.control_mode), ref)
    assert not check.verdict(numbers, o["limits"]), numbers


def test_a_half_batch_is_not_correct():
    res = _run(dict(small(), fault="half_batch"))
    assert not res["correct"], res["checks"]


def test_an_ema_left_unchanged_is_not_correct(monkeypatch):
    from coot_videotext_tpu_torch.train import optim
    monkeypatch.setattr(optim.EMA, "update", lambda self, step: None)
    res = _run(small())
    assert not res["correct"]
    # every leaf at or above the median norm reads 1; with an even count
    # of leaves the median averages one of them with the next below
    assert res["checks"]["ema3_median_leaf_gap"]["value"] == pytest.approx(
        1.0, abs=0.01)


def test_the_traffic_maps_segments_to_rows_as_the_caption_dataset():
    """Row ranges from the release's seconds by frame_to_second_table's
    YouCook2 rounding and _convert_to_feat_index_st_ed, for the first
    videos of annotations/youcook2."""
    import json
    root = run.ROOT / "annotations" / "youcook2"
    with open(root / "captioning_train.json", encoding="utf8") as fh:
        anns = list(json.load(fh).items())[:20]
    durations = {}
    for line in (root / "captioning_video_feat_duration.csv").read_text(
            ).splitlines():
        name, dur, frames = line.split(",")
        durations[name] = (float(dur), float(frames))
    _, _, traffic, _ = run.load_cell(tiny.BENCH, CELL)
    for i, (name, entry) in enumerate(anns):
        dur, frames = durations[name]
        per_row = dur * math.ceil(frames / dur * 0.5) / frames
        rows = math.ceil(dur / per_row)
        assert traffic["feature_rows"][i] == rows
        for (st, ed), (t0, t1) in zip(traffic["segments"][i],
                                      entry["timestamps"]):
            e = min(math.ceil(t1 / per_row), rows - 1)
            assert (st, ed) == (min(math.floor(t0 / per_row), e - 1), e)


def test_a_batch_holds_each_segments_rows_between_cls_and_sep():
    o = small()
    cell = caption_train_xl.Cell(o["config"], o["traffic"], SEED, CPU)
    b = cell.batch(np.arange(4))["batch"]
    v_len = int(o["config"]["max_v_len"])
    offsets = np.cumsum([0] + o["traffic"]["feature_rows"])
    for n in range(4):
        st, ed = o["traffic"]["segments"][n][0]
        rows = np.arange(st, ed + 1)
        if len(rows) > v_len - 2:
            rows = np.linspace(st, ed, v_len - 2).astype(np.int64)
        valid = len(rows)
        ids = b["input_ids"][0, n]
        assert ids[0] == 1 and ids[valid + 1] == 2
        assert torch.equal(b["video_feature"][0, n, 1:valid + 1],
                           cell.features[offsets[n] + rows])
        assert not b["video_feature"][0, n, valid + 1:].any()
        assert b["input_mask"][0, n, :v_len].sum() == valid + 2


def _trace(marks):
    kernels = [(f"phase_mark_{name}()", t, t + 1e-6) for t, name in marks]
    return Trace(kernels, [], 0.0, 1.0)


def test_relattn_ms_sums_each_bracket_inside_whole_steps():
    reader = run.reader("relattn_ms.train")
    step = [(0.10, "forward"), (0.11, "relattn"), (0.13, "relattn_end"),
            (0.20, "backward"), (0.21, "relattn"), (0.25, "relattn_end"),
            (0.30, "optimizer"), (0.31, "end")]
    late = [(t + 0.5, n) for t, n in step[:3]]  # a step cut by the window
    value = reader({"trace": _trace(step + late), "steps": 2})
    assert value == pytest.approx(1e3 * (0.02 + 0.04))
    assert reader({"trace": _trace([m for m in step if "relattn" not in
                                    m[1]]), "steps": 1}) is None


@pytest.mark.parametrize("q,k", [(3, 3), (3, 5)])
def test_the_work_counts_every_product_of_a_step(q, k):
    """One layer, without and with memory rows: the forward products by
    hand, three times where the input takes a gradient, twice where it is
    data or detached (the video stack, k and v of the memory rows, r_net);
    the memory rows' q, which the model drops, is not counted."""
    cfg = {"hidden_size": 8, "intermediate_size": 6, "word_vec_size": 5,
           "video_feature_size": 7, "vocab_size": 11,
           "num_hidden_layers": 1}
    fwd = 2 * q * (5 * 8 + 3 * 8 * 8 + 3 * k * 8 + 8 * 8
                   + 2 * 8 * 6 + 8 * 8 + 8 * 11)
    data = 2 * q * 7 * 8 + 2 * (k - q) * 8 * 2 * 8 + 2 * k * 8 * 8
    assert caption_train_xl.xl_step_flops(cfg, q, k) == 3 * fwd + 2 * data
