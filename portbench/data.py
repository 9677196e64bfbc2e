"""
The retrieval split the benchmark serves, made from its parameters.

The split's sizes (videos, frames a video, clips and their frame ranges,
tokens a sentence) are the real dataset's (`splits/<name>.json`, named by
the configuration's `split`): every run, on every seed, holds the same
set of sizes. The features are drawn from the
run's seed on the device, straight into the program's feature store in
the store's dtype, in a few large calls; nothing is written to disk.

`RetrievalSplit` is what both sides take: the program gets `store` and
`dataset` (the attributes its device store and metadata read), the
reference gets `meta` and the same two feature tensors.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# the padding ladders of a batch's dims (the program's data pipeline pads
# to the smallest entry >= the longest; the benchmark states them so that
# the reference needs nothing of the program)
LENGTH_LADDER = (8, 16, 24, 32, 48, 64, 80, 96, 128, 160, 192, 256, 320,
                 384, 448, 512, 640, 768, 896, 1024, 1280, 1536, 2048)
COUNT_LADDER = (1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128)


def bucket(n: int, ladder) -> int:
    for v in ladder:
        if v >= n:
            return v
    return (n + 7) // 8 * 8


def split_meta(split_cfg: dict, split: str, add_stop_frame: int
               ) -> List[dict]:
    """Per video of `split` in `splits/<name>.json`: frames `nf` (the
    duration at `feature_rows_per_s`), clips `segs` [(first frame,
    frames)], sentence token counts `splits`. Segment bounds are mapped
    to frames as the COOT dataset maps them (floor of the start, ceil of
    the stop plus `add_stop_frame`, clipped to the video). `max_videos`
    (tests) keeps the split's first videos."""
    with open(HERE / "splits" / f"{split_cfg['name']}.json",
              encoding="utf8") as fh:
        videos = json.load(fh)[split]
    videos = videos[:split_cfg.get("max_videos", len(videos))]
    rate = float(split_cfg["feature_rows_per_s"])
    out = []
    for duration, segments in videos:
        nf = int(duration * rate)
        fps = nf / duration
        segs, tokens = [], []
        for t0, t1, n in segments:
            t0, t1 = min(t0, t1), max(t0, t1)
            first = int(math.floor(fps * t0))
            stop = min(int(math.ceil(fps * t1)) + add_stop_frame, nf)
            segs.append((first, stop - first))
            tokens.append(int(n))
        out.append({"nf": nf, "segs": segs, "splits": tokens})
    return out


def fixed_shapes(meta: List[dict], max_frames: int) -> Dict[str, int]:
    """The split's padded dims: every batch of it has one shape."""
    return {
        "lv": bucket(min(max_frames, max(v["nf"] for v in meta)),
                     LENGTH_LADDER),
        "lc": bucket(min(max_frames, max(n for v in meta
                                         for _, n in v["segs"])),
                     LENGTH_LADDER),
        "ls": bucket(max(max(v["splits"]) for v in meta), LENGTH_LADDER),
        "lp": bucket(max(sum(v["splits"]) for v in meta), LENGTH_LADDER),
        "n_parts": bucket(max(len(v["segs"]) for v in meta), COUNT_LADDER),
    }


class _Dataset:
    """The attributes of a retrieval dataset that the program's device
    store and metadata read."""

    def __init__(self, meta: List[dict]) -> None:
        self.keys = [f"video{i:04d}" for i in range(len(meta))]
        self.data_keys = list(self.keys)
        self.meta = {}
        self._splits = {}
        for key, v in zip(self.keys, meta):
            self.meta[key] = {
                "start_frame_vid": 0, "num_frames_vid": v["nf"],
                "segments": [{"start_frame": s, "num_frames": n}
                             for s, n in v["segs"]]}
            self._splits[key] = list(v["splits"])

    def sentence_split(self, key: str, default=None):
        return self._splits.get(key, default)


class _Store:
    """The attributes of the program's device feature store."""

    def __init__(self, dataset, vid_store, text_store, vid_off, text_off):
        self.dataset = dataset
        self.device = vid_store.device
        self.vid_store = vid_store
        self.text_store = text_store
        self.vid_offset = dict(zip(dataset.data_keys, vid_off))
        self.text_offset = dict(zip(dataset.keys, text_off))


def _normal_rows(rows: int, dim: int, dtype, device, gen,
                 chunk_rows: int = 1 << 17) -> torch.Tensor:
    out = torch.empty((rows, dim), dtype=dtype, device=device)
    for r in range(0, rows, chunk_rows):
        n = min(chunk_rows, rows - r)
        out[r:r + n].normal_(generator=gen)
    return out


class RetrievalSplit:
    """A split's metadata and features, drawn as the module says."""

    def __init__(self, cfg: dict, split: str, seed: int,
                 device: torch.device, dtype: torch.dtype) -> None:
        ds = cfg["dataset_train"]
        self.meta = split_meta(cfg["split"], split,
                               int(ds["add_stop_frame"]))
        self.max_frames = int(ds["max_frames"])
        self.shapes = fixed_shapes(self.meta, self.max_frames)
        self.vid_off = np.cumsum([0] + [v["nf"] for v in self.meta])[:-1]
        self.text_off = np.cumsum([0] + [sum(v["splits"])
                                         for v in self.meta])[:-1]
        frames = int(sum(v["nf"] for v in self.meta))
        tokens = int(sum(sum(v["splits"]) for v in self.meta))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed & ((1 << 63) - 1))
        self.vid_store = _normal_rows(frames, int(ds["vid_feat_dim"]), dtype,
                                      device, gen)
        self.text_store = _normal_rows(tokens, int(ds["text_feat_dim"]),
                                       dtype, device, gen)
        self.dataset = _Dataset(self.meta)
        self.store = _Store(self.dataset, self.vid_store, self.text_store,
                            [int(x) for x in self.vid_off],
                            [int(x) for x in self.text_off])

    def __len__(self) -> int:
        return len(self.meta)

    def valid_counts(self, ids) -> Dict[str, int]:
        """Rows of real work of the videos `ids` (sampled frames, clip
        frames, paragraph and sentence tokens, clips), each capped at
        max_frames as the sampler caps them."""
        mf = self.max_frames
        out = {"videos": 0, "vid_rows": 0, "clip_rows": 0, "par_rows": 0,
               "sent_rows": 0, "clips": 0, "vid_sq": 0, "clip_sq": 0,
               "par_sq": 0, "sent_sq": 0, "clips_sq": 0}
        for i in ids:
            v = self.meta[int(i)]
            lv = min(v["nf"], mf)
            lcs = [min(n, mf) for _, n in v["segs"]]
            lp = sum(v["splits"])
            out["videos"] += 1
            out["vid_rows"] += lv
            out["vid_sq"] += lv * lv
            out["clip_rows"] += sum(lcs)
            out["clip_sq"] += sum(c * c for c in lcs)
            out["par_rows"] += lp
            out["par_sq"] += lp * lp
            out["sent_rows"] += sum(v["splits"])
            out["sent_sq"] += sum(s * s for s in v["splits"])
            out["clips"] += len(lcs)
            out["clips_sq"] += len(lcs) * len(lcs)
        return out
