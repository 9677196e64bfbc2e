"""
Retrieval dataset: metadata -> frame sampling -> batches for the step.

Port of coot_videotext_tpu/data/retrieval_dataset.py: the dataset (with
`get_indices` :151 for the store path), the dense `collate_fn` :438, the
packed-transfer `collate_slab` :273, `compute_fixed_shapes` :406,
`RetrievalBatchLoader` :538 with its device store, device metadata and
pack_transfer modes, `estimate_store_bytes` :626, `device_store_budget` :638
and the factory :657. Batches are numpy dicts with validity masks (True =
valid); the trainers ship them through data/pipeline.py `prefetch`, and
`to_device`, the sequential copy, is the reference it is held against
(tests, chip_smoke.py). JAX's `compute_slab_budgets` :235 is left out: it gives
jit one slab shape, and the eager step takes any.

Each batch names its layout under "layout" (LAYOUTS; the factory picks one
per loader in `_layout`, as JAX's `_pack` does):
    - "ids" (`dp_idx`): the store and its metadata are on the device, which
      samples the frames and packs the parts (data/device_store.py); needs
      dataset-static shapes (`--fixed_shapes`);
    - "indices" (`vid_idx`, ...): the store is on the device, the host
      samples the frames;
    - "slab" (`vid_store`, `text_store` + indices): the host samples and
      noises, and ships only the sampled rows;
    - "dense" (`vid_feat`, ...): everything on the host.
`preload_device: "auto"` takes the store on a CUDA device when it fits
0.55 of the free device memory, and the host path on the CPU (there is no
host-to-device link to save there); `pack_transfer: "auto"` is on for the
host path on a CUDA device only.
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from coot_videotext_tpu_torch.data.device_store import index_dims
from coot_videotext_tpu_torch.data.features_loader import (
    TextFeaturesLoader, VideoFeatureLoader)
from coot_videotext_tpu_torch.parallel.mesh import Mesh, batch_rows
from coot_videotext_tpu_torch.tasks.retrieval.config import (
    RetrievalDatasetConfig)
from coot_videotext_tpu_torch.utils import maths
from coot_videotext_tpu_torch.utils.general import LOGGER_NAME

TRAIN_SPLIT = "train"
DEFAULT_SUBSET = "default"

# padding ladders: smallest entry >= n is used as the padded size, so a
# handful of batch shapes recur instead of one per batch
LENGTH_LADDER = [8, 16, 24, 32, 48, 64, 80, 96, 128, 160, 192, 256,
                 320, 384, 448, 512, 640, 768, 896, 1024, 1280, 1536, 2048]
COUNT_LADDER = [1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128]

# host-only fields of a collated batch (strings, never sent to the device)
HOST_KEYS = ("key", "data_key", "sentences", "layout")
# the batch layouts, from the least the host ships to the most
LAYOUTS = ("ids", "indices", "slab", "dense")
# a batch's padded dims, as `compute_fixed_shapes` names them
DIM_KEYS = ("lv", "lc", "ls", "lp", "n_parts")


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

    def sentence_split(self, key: str, default=None) -> List[int]:
        splits = self.text_feats.sentence_splits
        return splits.get(key, splits.get(f"v_{key[:11]}", default))

    def get_indices(self, item: int) -> Dict[str, Any]:
        """
        Index-only datapoint for the store path: the sampled frame indices
        (video-relative) instead of feature arrays, with the same sampling
        and random stream as __getitem__ (no noise: the store path adds it
        on the device).
        """
        key = self.keys[item]
        vid = self.meta[key]
        cfg = self.cfg
        vid_len = min(vid["num_frames_vid"], cfg.max_frames)
        vid_idx = maths.compute_indices(vid["num_frames_vid"], vid_len,
                                        self.is_train, rng=self.rng)
        vid_idx = vid_idx + vid["start_frame_vid"]
        clip_idx = []
        for seg in vid["segments"]:
            c_len = min(seg["num_frames"], cfg.max_frames)
            cidx = maths.compute_indices(seg["num_frames"], c_len,
                                         self.is_train, rng=self.rng)
            clip_idx.append(cidx + seg["start_frame"])
        sentences = [seg["text"] if seg["text"] is not None else "undefined"
                     for seg in vid["segments"]]
        sent_split = self.sentence_split(key)
        return {
            "key": key,
            "data_key": vid["data_key"],
            "sentences": sentences,
            "vid_idx": vid_idx,
            "clip_idx": clip_idx,
            "clip_num": len(clip_idx),
            "par_len": int(sum(sent_split)),
            "sent_split": list(sent_split),
        }

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

    @staticmethod
    def _batch_dims(points: List[Dict[str, Any]],
                    fixed_shapes: Optional[Dict[str, int]]):
        """(lv, lc, ls, lp, n_parts) of a batch of feature points: the
        dataset-static shapes, or the batch maxima bucketed."""
        if fixed_shapes is not None:
            return tuple(fixed_shapes[k] for k in DIM_KEYS)
        return (
            bucket_size(max(p["vid_feat"].shape[0] for p in points),
                        LENGTH_LADDER),
            bucket_size(max(c.shape[0] for p in points
                            for c in p["clip_feats"]), LENGTH_LADDER),
            bucket_size(max(s.shape[0] for p in points
                            for s in p["sent_feats"]), LENGTH_LADDER),
            bucket_size(max(p["par_feat"].shape[0] for p in points),
                        LENGTH_LADDER),
            bucket_size(max(max(p["clip_num"], p["sent_num"])
                            for p in points), COUNT_LADDER))

    def collate_slab(self, points: List[Dict[str, Any]], *,
                     batch_size: Optional[int] = None,
                     fixed_shapes: Optional[Dict[str, int]] = None
                     ) -> Dict[str, Any]:
        """
        Packed-transfer collation, the bit-exact twin of collate_fn that
        ships fewer bytes: instead of the dense zero-padded [B, N, L, D]
        features the batch carries two packed row slabs, `vid_store` (video
        and clip frames) and `text_store` (paragraph tokens; sentences index
        the same rows), plus the int32 index fields of
        `RetrievalDeviceStore.collate_indices`. The step rebuilds the dense
        batch on the device with B5 (data/device_store.py
        gather_dense_batch): the same floats collate_fn would have placed.
        """
        n_real = len(points)
        b = batch_size if batch_size is not None else n_real
        assert b >= n_real
        dv, dt = self.cfg.vid_feat_dim, self.cfg.text_feat_dim
        lv, lc, ls, lp, n_parts = self._batch_dims(points, fixed_shapes)

        # row 0 of each slab is an all-zero row: every padded index points
        # there, so the gather gives zeros at padded positions, as
        # collate_fn does
        need_vid = 1 + sum(p["vid_feat"].shape[0]
                           + sum(c.shape[0] for c in p["clip_feats"])
                           for p in points)
        need_text = 1 + sum(p["par_feat"].shape[0] for p in points)
        rv = -(-need_vid // 4096) * 4096
        rt = -(-need_text // 4096) * 4096

        batch = {
            "key": [p["key"] for p in points],
            "data_key": [p["data_key"] for p in points],
            "sentences": [p["sentences"] for p in points],
            "batch_valid": np.zeros(b, bool),
            "vid_store": np.zeros((rv, dv), np.float32),
            "text_store": np.zeros((rt, dt), np.float32),
            "vid_idx": np.zeros((b, lv), np.int32),
            "vid_mask": np.zeros((b, lv), bool),
            "vid_len": np.ones(b, np.int32),
            "clip_idx": np.zeros((b, n_parts, lc), np.int32),
            "clip_mask": np.zeros((b, n_parts, lc), bool),
            "clip_len": np.zeros((b, n_parts), np.int32),
            "clip_valid": np.zeros((b, n_parts), bool),
            "clip_num": np.ones(b, np.int32),
            "par_idx": np.zeros((b, lp), np.int32),
            "par_mask": np.zeros((b, lp), bool),
            "par_len": np.ones(b, np.int32),
            "sent_idx": np.zeros((b, n_parts, ls), np.int32),
            "sent_mask": np.zeros((b, n_parts, ls), bool),
            "sent_len": np.zeros((b, n_parts), np.int32),
            "sent_valid": np.zeros((b, n_parts), bool),
            "sent_num": np.ones(b, np.int32),
        }
        vid_store = batch["vid_store"]
        text_store = batch["text_store"]
        vp = tp = 1  # row 0 = the zero row
        for i, p in enumerate(points):
            batch["batch_valid"][i] = True
            nv = p["vid_feat"].shape[0]
            vid_store[vp:vp + nv] = p["vid_feat"]
            batch["vid_idx"][i, :nv] = vp + np.arange(nv)
            batch["vid_mask"][i, :nv] = True
            batch["vid_len"][i] = nv
            vp += nv
            batch["clip_num"][i] = p["clip_num"]
            for j, c in enumerate(p["clip_feats"]):
                nc = c.shape[0]
                vid_store[vp:vp + nc] = c
                batch["clip_idx"][i, j, :nc] = vp + np.arange(nc)
                batch["clip_mask"][i, j, :nc] = True
                batch["clip_len"][i, j] = nc
                batch["clip_valid"][i, j] = True
                vp += nc
            np_tok = p["par_feat"].shape[0]
            text_store[tp:tp + np_tok] = p["par_feat"]
            batch["par_idx"][i, :np_tok] = tp + np.arange(np_tok)
            batch["par_mask"][i, :np_tok] = True
            batch["par_len"][i] = np_tok
            batch["sent_num"][i] = p["sent_num"]
            ptr = 0
            # sentences are slices of the paragraph rows: index, not copy
            for j, sf in enumerate(p["sent_feats"]):
                ns = sf.shape[0]
                batch["sent_idx"][i, j, :ns] = tp + ptr + np.arange(ns)
                batch["sent_mask"][i, j, :ns] = True
                batch["sent_len"][i, j] = ns
                batch["sent_valid"][i, j] = True
                ptr += ns
            tp += np_tok
        # padded batch rows: one valid slot so masked math stays finite
        for i in range(n_real, b):
            batch["vid_mask"][i, 0] = True
            batch["par_mask"][i, 0] = True
            batch["clip_mask"][i, 0, 0] = True
            batch["clip_len"][i, 0] = 1
            batch["clip_valid"][i, 0] = True
            batch["sent_mask"][i, 0, 0] = True
            batch["sent_len"][i, 0] = 1
            batch["sent_valid"][i, 0] = True
        return batch

    def compute_fixed_shapes(self) -> Dict[str, int]:
        """Dataset-level padded dims (lv, lc, ls, lp, n_parts): every batch
        padded to these has one shape, which the device sampler and the
        pack budgets need."""
        cfg = self.cfg
        splits = [self.sentence_split(k, [1]) for k in self.keys]
        return {
            "lv": bucket_size(
                min(cfg.max_frames,
                    max(self.meta[k]["num_frames_vid"] for k in self.keys)),
                LENGTH_LADDER),
            "lc": bucket_size(
                min(cfg.max_frames,
                    max(seg["num_frames"] for k in self.keys
                        for seg in self.meta[k]["segments"])),
                LENGTH_LADDER),
            "ls": bucket_size(max(max(s) for s in splits), LENGTH_LADDER),
            "lp": bucket_size(max(sum(s) for s in splits), LENGTH_LADDER),
            "n_parts": bucket_size(
                max(len(self.meta[k]["segments"]) for k in self.keys),
                COUNT_LADDER),
        }

    def collate_fn(self, points: List[Dict[str, Any]], *,
                   batch_size: Optional[int] = None,
                   fixed_shapes: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
        """
        Collate datapoints into one dense, bucket-padded numpy batch.

        If `batch_size` > len(points) the batch is padded with zero videos
        carrying batch_valid=False; the losses and eval mask them out.
        `fixed_shapes` (compute_fixed_shapes) replaces the per-batch
        bucketing with dataset-level dims.
        """
        n_real = len(points)
        b = batch_size if batch_size is not None else n_real
        assert b >= n_real

        dv, dt = self.cfg.vid_feat_dim, self.cfg.text_feat_dim
        lv, lc, ls, lp, n_parts = self._batch_dims(points, fixed_shapes)

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
    """Array fields -> tensors on `device`, in the caller's thread: the
    sequential reference that data/pipeline.py `prefetch` is held against
    (no trainer calls it). For a CUDA device the host arrays are pinned
    first and copied with non_blocking=True; the host-only string fields
    are passed through unchanged."""
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
    final-batch padding, len() in batches. Every batch is of `layout`
    (LAYOUTS) and says so under "layout": "ids" needs `device_meta`,
    "indices" `device_store`, and both need `fixed_shapes` (the dataset's
    `compute_fixed_shapes`) or None for per-batch bucketing.

    Under a data-parallel `mesh` (parallel/mesh.py) `batch_size` is the
    global batch, as in JAX, and each rank gets its `local_batch` rows of
    every global batch in the same order (a short last batch is padded at
    its end, so a rank may hold padded rows only). The host layouts
    sample every point of the global batch (the host's random stream of
    one process) and collate the rank's rows at the global batch's dims.
    """

    def __init__(self, dataset: RetrievalDataset, batch_size: int, *,
                 shuffle: bool, drop_last: bool = False, seed: int = 0,
                 layout: str = "dense",
                 fixed_shapes: Optional[Dict[str, int]] = None,
                 device_store=None, device_meta=None,
                 mesh: Optional[Mesh] = None) -> None:
        if layout not in LAYOUTS:
            raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
        if (layout == "ids") != (device_meta is not None) or \
                (layout in ("ids", "indices")) != (device_store is not None):
            raise ValueError(f"layout {layout!r} with store "
                             f"{device_store is not None} and metadata "
                             f"{device_meta is not None}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.layout = layout
        self.fixed_shapes = fixed_shapes
        self.device_store = device_store
        self.device_meta = device_meta
        self.mesh = mesh
        self.rows = batch_rows(mesh, batch_size)
        self.local_batch = self.rows.stop - self.rows.start

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _id_batch(self, idx: np.ndarray) -> Dict[str, Any]:
        ds = self.dataset
        dp_idx = np.zeros(self.local_batch, np.int32)
        dp_idx[:len(idx)] = idx
        batch_valid = np.zeros(self.local_batch, bool)
        batch_valid[:len(idx)] = True
        keys = [ds.keys[int(i)] for i in idx]
        return {
            "key": keys,
            "data_key": [ds.data_keys[int(i)] for i in idx],
            "sentences": [[seg["text"] or "undefined"
                           for seg in ds.meta[k]["segments"]] for k in keys],
            "dp_idx": dp_idx,
            "batch_valid": batch_valid,
        }

    def _collate(self, idx: np.ndarray) -> Dict[str, Any]:
        """The rank's rows of the global batch `idx` (all of it at world
        1)."""
        if self.layout == "ids":
            return self._id_batch(idx[self.rows])
        if self.layout == "indices":
            points = [self.dataset.get_indices(int(i)) for i in idx]
            return self.device_store.collate_indices(
                points[self.rows], batch_size=self.local_batch,
                fixed_shapes=self.fixed_shapes or index_dims(points))
        points = [self.dataset[int(i)] for i in idx]
        dims = self.fixed_shapes or dict(zip(
            DIM_KEYS, self.dataset._batch_dims(points, None)))
        kw = dict(batch_size=self.local_batch, fixed_shapes=dims)
        if self.layout == "slab":
            return self.dataset.collate_slab(points[self.rows], **kw)
        return self.dataset.collate_fn(points[self.rows], **kw)

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
            yield {"layout": self.layout, **self._collate(idx)}


def estimate_store_bytes(dataset: RetrievalDataset,
                         bytes_per_elem: int = 2) -> int:
    """Estimated size of the full feature set in device memory (every
    sentence split of the text file counts, as in JAX)."""
    vid = sum(dataset.vid_feats.num_frames.get(k, 0)
              for k in set(dataset.data_keys)) * dataset.cfg.vid_feat_dim
    text = sum(sum(s) for s in
               dataset.text_feats.sentence_splits.values()) * \
        dataset.cfg.text_feat_dim
    return (vid + text) * bytes_per_elem


def device_free_bytes(device: torch.device) -> float:
    """Free memory of a CUDA device; unbounded for the CPU."""
    if device.type != "cuda":
        return math.inf
    return float(torch.cuda.mem_get_info(device)[0])


def device_store_budget(device: torch.device,
                        fraction: float = 0.55) -> float:
    """Device memory for the "auto" store decision: a fraction of the free
    memory (the rest is headroom for parameters, optimizer state,
    activations and the allocator)."""
    return fraction * device_free_bytes(device)


def _store_dtype(cfg) -> torch.dtype:
    return (torch.bfloat16 if str(cfg.compute_dtype) == "bfloat16"
            else torch.float32)


def _decide_store(cfg, train_set, val_set, device: torch.device,
                  device_preload: Optional[bool]) -> bool:
    """The store decision: `device_preload`, else the config's
    `preload_device` (true / false / "auto"). "auto" takes the store on a
    CUDA device when it fits `device_store_budget` and logs when it does
    not, and the host path on the CPU; a forced store that does not fit the
    free device memory raises."""
    if device_preload is None:
        knob = cfg.dataset_train.preload_device
        if knob == "auto" and device.type != "cuda":
            return False
        device_preload = knob if knob == "auto" else bool(knob)
    if device_preload is False:
        return False
    itemsize = torch.empty((), dtype=_store_dtype(cfg)).element_size()
    need = (estimate_store_bytes(train_set, itemsize)
            + estimate_store_bytes(val_set, itemsize))
    if device_preload == "auto":
        budget = device_store_budget(device)
        if need >= budget:
            logging.getLogger(LOGGER_NAME).warning(
                f"preload_device auto: the feature store ({need / 1e9:.2f} "
                f"GB) does not fit the budget ({budget / 1e9:.2f} GB); "
                "taking the host path")
        return need < budget
    free = device_free_bytes(device)
    if need > free:
        raise RuntimeError(
            f"preload_device: the feature store needs {need / 1e9:.2f} GB, "
            f"{device} has {free / 1e9:.2f} GB free")
    return True


def _layout(dset_cfg, use_store: bool, fixed_shapes: bool,
            sample_on_device: bool, device: torch.device) -> str:
    """A loader's batch layout: with the store "ids" (fixed shapes and
    `sample_on_device`) or "indices"; without it "slab" where
    `pack_transfer` says so ("auto": on a CUDA device), else "dense"."""
    if use_store:
        return "ids" if fixed_shapes and sample_on_device else "indices"
    knob = dset_cfg.pack_transfer
    if knob == "auto":
        knob = device.type == "cuda"
    return "slab" if knob else "dense"


def create_retrieval_datasets_and_loaders(
        cfg, path_data: Union[str, Path], *, seed: int = 0,
        verbose: bool = False, fixed_shapes: Optional[bool] = None,
        device_preload: Optional[bool] = None,
        device: torch.device = torch.device("cpu"),
        mesh: Optional[Mesh] = None):
    """Factory (reference dataset_retrieval.py:466, JAX :657). `fixed_shapes`
    defaults to the config's `pad_fixed_shapes`, `device_preload` to its
    `preload_device` (see `_decide_store`). With the store, the loaders
    yield index batches over a `RetrievalDeviceStore` on `device`; with the
    store, fixed shapes and `sample_on_device`, id batches sampled on the
    device (`RetrievalDeviceMeta`, parts packed unless `pack_parts` is
    false); see `_layout`. Under a data-parallel `mesh` every rank holds
    the whole store on its device (JAX replicates it) and gets its rows of
    each global batch; the pack budgets are those of a rank's rows."""
    from coot_videotext_tpu_torch.data.device_store import (
        RetrievalDeviceMeta, RetrievalDeviceStore)
    if fixed_shapes is None:
        fixed_shapes = cfg.dataset_train.pad_fixed_shapes
    train_rng = np.random.RandomState(seed)
    val_rng = np.random.RandomState(seed + 1)
    train_set = RetrievalDataset(cfg.dataset_train, path_data,
                                 verbose=verbose, rng=train_rng)
    val_set = RetrievalDataset(cfg.dataset_val, path_data,
                               verbose=verbose, rng=val_rng)
    use_store = _decide_store(cfg, train_set, val_set, device,
                              device_preload)

    def loader(dataset, dset_cfg, batch_size, train):
        layout = _layout(dset_cfg, use_store, fixed_shapes,
                         cfg.dataset_train.sample_on_device, device)
        shapes = dataset.compute_fixed_shapes() if fixed_shapes else None
        store = meta = None
        if use_store:
            store = RetrievalDeviceStore(dataset, dtype=_store_dtype(cfg),
                                         device=device)
        rows = batch_rows(mesh, batch_size)
        if layout == "ids":
            meta = RetrievalDeviceMeta(store, shapes, dset_cfg.max_frames,
                                       batch_size=rows.stop - rows.start,
                                       pack_parts=dset_cfg.pack_parts)
        return RetrievalBatchLoader(
            dataset, batch_size, shuffle=train and dset_cfg.shuffle,
            drop_last=train and dset_cfg.drop_last, seed=seed,
            layout=layout, fixed_shapes=shapes, device_store=store,
            device_meta=meta, mesh=mesh)

    train_loader = loader(train_set, cfg.dataset_train, cfg.train.batch_size,
                          True)
    val_loader = loader(val_set, cfg.dataset_val, cfg.val.batch_size, False)
    return train_set, val_set, train_loader, val_loader
