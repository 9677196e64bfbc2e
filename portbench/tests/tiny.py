"""Small cells for the CPU tests: the published widths on splits and
batches a test run can hold."""

from __future__ import annotations

import copy

from portbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


def coot(workload: str, f32: bool = False):
    """The published widths on a small split: the first 24 videos of
    each split, at most 16 frames a sequence, batches of 4."""
    _, cfg, traffic, limits = run.load_cell(BENCH, workload)
    cfg = copy.deepcopy(cfg)
    cfg["dataset_train"]["max_frames"] = 16
    cfg["split"]["max_videos"] = 24
    if f32:
        cfg.update(fp16_train=False, fp16_val=False)
    return dict(config=cfg, traffic=dict(traffic, batch_size=4),
                limits=limits)


def mart():
    """The published widths on the first 20 videos, one batch."""
    _, cfg, traffic, limits = run.load_cell(BENCH, "mart-yc2-coot.greedy")
    return dict(config=cfg, traffic=dict(
        traffic, batch_size=20, sentences=traffic["sentences"][:20]),
        limits=limits)


def mart_train():
    """The published widths on 12 videos in batches of 4."""
    _, cfg, traffic, limits = run.load_cell(BENCH, "mart-yc2-coot.train")
    return dict(config=cfg, traffic=dict(
        traffic, batch_size=4, videos=traffic["videos"][:12]),
        limits=limits)
