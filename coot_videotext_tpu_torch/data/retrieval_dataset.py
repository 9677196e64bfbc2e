"""
Retrieval dataset: metadata -> frame sampling -> dense bucket-padded batches.

Port of coot_videotext_tpu/data/retrieval_dataset.py (the host path: the
dataset, `collate_fn` :438 and `RetrievalBatchLoader` :538). Batches are dense
[B, N_parts, L, D] numpy arrays with validity masks (True = valid), padded to
bucketed sizes; `to_device` pins them and copies them to the device without
blocking the host.

Left out until the device feature store is ported (ROADMAP A7, kernel B5):
the HBM-resident store (`device_store_budget` :638, `RetrievalDeviceStore`,
`RetrievalDeviceMeta` :675-738) and the packed-slab transfer (`collate_slab`).
`preload_device: "auto"` therefore takes the host path, and an explicit
`true` raises.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from coot_videotext_tpu_torch.data.features_loader import (
    TextFeaturesLoader, VideoFeatureLoader)
from coot_videotext_tpu_torch.tasks.retrieval.config import (
    RetrievalDatasetConfig)
from coot_videotext_tpu_torch.utils import maths

TRAIN_SPLIT = "train"
DEFAULT_SUBSET = "default"

# padding ladders: smallest entry >= n is used as the padded size, so a
# handful of batch shapes recur instead of one per batch
LENGTH_LADDER = [8, 16, 24, 32, 48, 64, 80, 96, 128, 160, 192, 256,
                 320, 384, 448, 512, 640, 768, 896, 1024, 1280, 1536, 2048]
COUNT_LADDER = [1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128]

# host-only fields of a collated batch (strings, never sent to the device)
HOST_KEYS = ("key", "data_key", "sentences")


def bucket_size(n: int, ladder: List[int]) -> int:
    """Smallest ladder value >= n (falls back to n rounded up to 8)."""
    for v in ladder:
        if v >= n:
            return v
    return ((n + 7) // 8) * 8


def truncnorm_noise(shape, std: float, rng: np.random.RandomState
                    ) -> np.ndarray:
    """Truncated normal noise, resampling |x| > 2 std (reference
    utils_torch.py:73-109 get_truncnorm_tensor)."""
    out = rng.randn(*shape) * std
    bad = np.abs(out) > 2 * std
    while bad.any():
        out[bad] = rng.randn(int(bad.sum())) * std
        bad = np.abs(out) > 2 * std
    return out.astype(np.float32)


class RetrievalDataset:
    """Map-style dataset over one split (reference RetrievalDataset :105)."""

    def __init__(self, cfg: RetrievalDatasetConfig,
                 path_data: Union[str, Path], *,
                 verbose: bool = False,
                 rng: Optional[np.random.RandomState] = None) -> None:
        self.path_data = Path(path_data)
        self.cfg = cfg
        self.split = cfg.split
        self.verbose = verbose
        self.is_train = self.split == TRAIN_SPLIT
        self.rng = rng if rng is not None else np.random.RandomState()
        self.path_dataset = self.path_data / cfg.name

        raw_meta_file = self.path_dataset / f"meta_{cfg.metadata_name}.json"
        raw_meta = json.loads(raw_meta_file.read_text(encoding="utf8"))

        if cfg.subset != DEFAULT_SUBSET:
            raise NotImplementedError(f"Subset {cfg.subset} not supported")
        self.keys = [k for k, v in raw_meta.items()
                     if v["split"] == self.split]
        if not self.keys:
            splits = sorted({v["split"] for v in raw_meta.values()})
            raise ValueError(
                f"No datapoints in split {self.split}; available: {splits}")
        if cfg.max_datapoints > -1:
            self.keys = self.keys[:cfg.max_datapoints]
        self.data_keys = [raw_meta[k]["data_key"] for k in self.keys]

        self.vid_feats = VideoFeatureLoader(
            self.path_dataset, cfg.vid_feat_name, cfg.vid_feat_source,
            self.data_keys, preload_vid_feat=cfg.preload_vid_feat)

        # build split metadata: segment frame ranges (reference :158-194)
        self.meta: Dict[str, Dict[str, Any]] = {}
        num_segments = 0
        expansions = 0
        for key, data_key in zip(self.keys, self.data_keys):
            meta = dict(raw_meta[key])
            num_frames = self.vid_feats.num_frames[data_key]
            meta["start_frame_vid"] = 0
            meta["stop_frame_vid"] = num_frames
            meta["num_frames_vid"] = num_frames
            fps = num_frames / meta["duration_sec"]
            segments = []
            for seg in meta["segments"]:
                seg = dict(seg)
                t0, t1 = seg["start_sec"], seg["stop_sec"]
                if t1 < t0:
                    t0, t1 = t1, t0
                start_frame = int(np.floor(fps * t0))
                stop_frame = int(np.ceil(fps * t1)) + cfg.add_stop_frame
                stop_frame = min(stop_frame, num_frames)
                start_frame, stop_frame, changed = maths.expand_video_segment(
                    num_frames, cfg.expand_segments, start_frame, stop_frame)
                if changed:
                    expansions += 1
                seg["start_frame"] = start_frame
                seg["num_frames"] = stop_frame - start_frame
                segments.append(seg)
                num_segments += 1
            meta["segments"] = segments
            self.meta[key] = meta
        if verbose:
            print(f"Built metadata for {self.split}: {len(self.keys)} "
                  f"datapoints, {num_segments} segments "
                  f"({expansions} expanded).")

        self.text_feats = TextFeaturesLoader(
            self.path_dataset, cfg.text_feat_name, cfg.text_feat_source,
            self.keys, preload_text_feat=cfg.preload_text_feat)

    def __len__(self) -> int:
        return len(self.keys)

    def _sample_frames(self, key: str, start: int, total: int,
                       target: int) -> np.ndarray:
        indices = maths.compute_indices(total, target, self.is_train,
                                        rng=self.rng)
        indices = indices + start
        data_key = self.meta[key]["data_key"]
        return self.vid_feats[data_key][indices]

    def __getitem__(self, item: int) -> Dict[str, Any]:
        key = self.keys[item]
        vid = self.meta[key]
        cfg = self.cfg

        clip_num = len(vid["segments"])

        vid_len = min(vid["num_frames_vid"], cfg.max_frames)
        vid_feat = self._sample_frames(
            key, vid["start_frame_vid"], vid["num_frames_vid"], vid_len)
        if cfg.frames_noise != 0:
            vid_feat = vid_feat + truncnorm_noise(
                vid_feat.shape, cfg.frames_noise, self.rng)

        clip_feats: List[np.ndarray] = []
        for seg in vid["segments"]:
            c_len = min(seg["num_frames"], cfg.max_frames)
            c = self._sample_frames(key, seg["start_frame"],
                                    seg["num_frames"], c_len)
            if cfg.frames_noise != 0:
                c = c + truncnorm_noise(c.shape, cfg.frames_noise, self.rng)
            clip_feats.append(c)

        sentences = [seg["text"] if seg["text"] is not None else "undefined"
                     for seg in vid["segments"]]

        par_feat, sent_split = self.text_feats[key]
        if cfg.words_noise != 0:
            par_feat = par_feat + truncnorm_noise(
                par_feat.shape, cfg.words_noise, self.rng)
        sent_feats: List[np.ndarray] = []
        ptr = 0
        for n_tok in sent_split:
            sent_feats.append(par_feat[ptr:ptr + n_tok])
            ptr += n_tok

        return {
            "key": key,
            "data_key": vid["data_key"],
            "sentences": sentences,
            "vid_feat": vid_feat.astype(np.float32),
            "clip_feats": clip_feats,
            "par_feat": par_feat.astype(np.float32),
            "sent_feats": sent_feats,
            "clip_num": clip_num,
            "sent_num": len(sent_feats),
        }

    # ---------- collation ----------

    def collate_fn(self, points: List[Dict[str, Any]], *,
                   batch_size: Optional[int] = None) -> Dict[str, Any]:
        """
        Collate datapoints into one dense, bucket-padded numpy batch
        (JAX collate_fn :438 without its dataset-static `fixed_shapes`).

        If `batch_size` > len(points) the batch is padded with zero videos
        carrying batch_valid=False; the losses and eval mask them out.
        """
        n_real = len(points)
        b = batch_size if batch_size is not None else n_real
        assert b >= n_real

        dv = points[0]["vid_feat"].shape[-1]
        dt = points[0]["par_feat"].shape[-1]

        lv = bucket_size(max(p["vid_feat"].shape[0] for p in points),
                         LENGTH_LADDER)
        lp = bucket_size(max(p["par_feat"].shape[0] for p in points),
                         LENGTH_LADDER)
        n_parts = bucket_size(
            max(max(p["clip_num"], p["sent_num"]) for p in points),
            COUNT_LADDER)
        lc = bucket_size(
            max(c.shape[0] for p in points for c in p["clip_feats"]),
            LENGTH_LADDER)
        ls = bucket_size(
            max(s.shape[0] for p in points for s in p["sent_feats"]),
            LENGTH_LADDER)

        batch = {
            "key": [p["key"] for p in points],
            "data_key": [p["data_key"] for p in points],
            "sentences": [p["sentences"] for p in points],
            "batch_valid": np.zeros(b, bool),
            "vid_feat": np.zeros((b, lv, dv), np.float32),
            "vid_mask": np.zeros((b, lv), bool),
            "vid_len": np.zeros(b, np.int32),
            "clip_feat": np.zeros((b, n_parts, lc, dv), np.float32),
            "clip_mask": np.zeros((b, n_parts, lc), bool),
            "clip_len": np.zeros((b, n_parts), np.int32),
            "clip_valid": np.zeros((b, n_parts), bool),
            "clip_num": np.zeros(b, np.int32),
            "par_feat": np.zeros((b, lp, dt), np.float32),
            "par_mask": np.zeros((b, lp), bool),
            "par_len": np.zeros(b, np.int32),
            "sent_feat": np.zeros((b, n_parts, ls, dt), np.float32),
            "sent_mask": np.zeros((b, n_parts, ls), bool),
            "sent_len": np.zeros((b, n_parts), np.int32),
            "sent_valid": np.zeros((b, n_parts), bool),
            "sent_num": np.zeros(b, np.int32),
        }
        for i, p in enumerate(points):
            batch["batch_valid"][i] = True
            nv = p["vid_feat"].shape[0]
            batch["vid_feat"][i, :nv] = p["vid_feat"]
            batch["vid_mask"][i, :nv] = True
            batch["vid_len"][i] = nv
            np_tok = p["par_feat"].shape[0]
            batch["par_feat"][i, :np_tok] = p["par_feat"]
            batch["par_mask"][i, :np_tok] = True
            batch["par_len"][i] = np_tok
            batch["clip_num"][i] = p["clip_num"]
            batch["sent_num"][i] = p["sent_num"]
            for j, c in enumerate(p["clip_feats"]):
                batch["clip_feat"][i, j, :c.shape[0]] = c
                batch["clip_mask"][i, j, :c.shape[0]] = True
                batch["clip_len"][i, j] = c.shape[0]
                batch["clip_valid"][i, j] = True
            for j, s in enumerate(p["sent_feats"]):
                batch["sent_feat"][i, j, :s.shape[0]] = s
                batch["sent_mask"][i, j, :s.shape[0]] = True
                batch["sent_len"][i, j] = s.shape[0]
                batch["sent_valid"][i, j] = True
        # padded batch rows: length >= 1 everywhere so masked softmaxes and
        # divisions stay finite (their outputs are masked out downstream)
        for i in range(n_real, b):
            batch["vid_mask"][i, 0] = True
            batch["vid_len"][i] = 1
            batch["par_mask"][i, 0] = True
            batch["par_len"][i] = 1
            batch["clip_mask"][i, 0, 0] = True
            batch["clip_len"][i, 0] = 1
            batch["clip_valid"][i, 0] = True
            batch["clip_num"][i] = 1
            batch["sent_mask"][i, 0, 0] = True
            batch["sent_len"][i, 0] = 1
            batch["sent_valid"][i, 0] = True
            batch["sent_num"][i] = 1
        return batch


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, Any]:
    """Array fields -> tensors on `device`. For a CUDA device the host
    arrays are pinned first and copied with non_blocking=True, so the copy
    overlaps whatever the host does next; the host-only string fields are
    passed through unchanged."""
    out: Dict[str, Any] = {}
    cuda = device.type == "cuda"
    for key, value in batch.items():
        if key in HOST_KEYS:
            out[key] = value
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        if cuda:
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out


class RetrievalBatchLoader:
    """
    Minimal DataLoader replacement (reference uses torch DataLoader,
    nntrainer/data.py:21): shuffled batching, static batch size with
    final-batch padding, len() in batches.
    """

    def __init__(self, dataset: RetrievalDataset, batch_size: int, *,
                 shuffle: bool, drop_last: bool = False,
                 seed: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            points = [self.dataset[int(i)] for i in idx]
            yield self.dataset.collate_fn(points,
                                          batch_size=self.batch_size)


def create_retrieval_datasets_and_loaders(
        cfg, path_data: Union[str, Path], *, seed: int = 0,
        verbose: bool = False):
    """Factory (reference dataset_retrieval.py:466). Host path only: the
    device feature store comes with kernel B5 (ROADMAP A7)."""
    for dset_cfg in (cfg.dataset_train, cfg.dataset_val):
        if dset_cfg.preload_device is True:
            raise NotImplementedError(
                "preload_device: true needs the device feature store, "
                "which is not ported yet (ROADMAP A7 / kernel B5); use "
                "\"auto\" or false for the host path.")
    train_rng = np.random.RandomState(seed)
    val_rng = np.random.RandomState(seed + 1)
    train_set = RetrievalDataset(cfg.dataset_train, path_data,
                                 verbose=verbose, rng=train_rng)
    val_set = RetrievalDataset(cfg.dataset_val, path_data,
                               verbose=verbose, rng=val_rng)
    train_loader = RetrievalBatchLoader(
        train_set, cfg.train.batch_size, shuffle=cfg.dataset_train.shuffle,
        drop_last=cfg.dataset_train.drop_last, seed=seed)
    val_loader = RetrievalBatchLoader(
        val_set, cfg.val.batch_size, shuffle=False, drop_last=False,
        seed=seed)
    return train_set, val_set, train_loader, val_loader
