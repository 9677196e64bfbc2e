"""
Host-side math utilities (copy of coot_videotext_tpu/utils/maths.py):
frame-index sampling and segment expansion. These run in the data pipeline
(numpy), never on device.

Exact behavioral port of reference nntrainer/maths.py (compute_indices :12,
expand_video_segment :64, np_round_half_down :140).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np


def compute_indices(num_frames_orig: int, num_frames_target: int,
                    is_train: bool,
                    rng: Optional[np.random.RandomState] = None
                    ) -> np.ndarray:
    """
    Pick `num_frames_target` frame indices out of `num_frames_orig`.
    Training draws one jittered index per (shuffled) uniform interval;
    validation takes each interval's center. The interval bookkeeping
    below is numerically pinned to reference maths.py:12 — golden tests
    compare outputs index-for-index.

    Args:
        rng: optional numpy RandomState; falls back to the global
            np.random stream like the original does.
    """
    if rng is None:
        rng = np.random
    if is_train:
        start_points = np.linspace(0, num_frames_orig, num_frames_target,
                                   endpoint=False)
        start_points = np_round_half_down(start_points).astype(int)
        offsets = start_points[1:] - start_points[:-1]
        rng.shuffle(offsets)
        last_offset = num_frames_orig - np.sum(offsets)
        offsets = np.concatenate([offsets, np.array([last_offset])])
        new_start_points = np.cumsum(offsets) - offsets[0]
        offsets = np.roll(offsets, -1)
        random_offsets = offsets * rng.rand(num_frames_target)
        indices = new_start_points + random_offsets
        return np.floor(indices).astype(int)
    start_points = np.linspace(0, num_frames_orig, num_frames_target,
                               endpoint=False)
    offset = num_frames_orig / num_frames_target / 2
    return np.floor(start_points + offset).astype(int)


def expand_video_segment(num_frames_video: int, min_frames_seg: int,
                         start_frame_seg: int, stop_frame_seg: int
                         ) -> Tuple[int, int, bool]:
    """
    Grow [start, stop) until it spans at least `min_frames_seg` frames,
    stealing one frame from the left then one from the right per
    iteration, clamped to the video bounds (pinned to reference
    maths.py:64; the left-first order affects which frames clips keep).
    """
    num_frames_seg = stop_frame_seg - start_frame_seg
    changes = False
    if min_frames_seg > num_frames_video:
        min_frames_seg = num_frames_video
    if num_frames_seg < min_frames_seg:
        while True:
            if start_frame_seg > 0:
                start_frame_seg -= 1
                num_frames_seg += 1
                changes = True
            if num_frames_seg == min_frames_seg:
                break
            if stop_frame_seg < num_frames_video:
                stop_frame_seg += 1
                num_frames_seg += 1
                changes = True
            if num_frames_seg == min_frames_seg:
                break
    return start_frame_seg, stop_frame_seg, changes


def np_round_half_down(array: Union[np.ndarray, Iterable]) -> np.ndarray:
    """Round, with halves going down (reference maths.py:140)."""
    array = np.asarray(array)
    return np.ceil(array - 0.5)


