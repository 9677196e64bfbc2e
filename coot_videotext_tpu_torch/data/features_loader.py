"""
Precomputed-feature loaders for the retrieval task.

Behavioral parity with reference coot/features_loader.py:16-195:
    - VideoFeatureLoader: h5 file `<features_name>.h5` keyed by data_key, or
      per-video npz `features/<features_name>/v_<data_key>.npz` (ActivityNet
      ICEP features); builds and caches `<features_name>_num_frames.json`
      over ALL keys in the store (load_all semantics, reference :40-47);
      optional full RAM preload.
    - TextFeaturesLoader: paragraph-level text feature h5
      `<features_name>.h5` plus `<features_name>_sentence_splits.json`
      holding per-sentence token counts used to cut paragraphs back into
      sentences; legacy `v_<key[:11]>` fallback kept (reference :152,182).

Copy of coot_videotext_tpu/data/features_loader.py with one more source,
"npy": one `<features_name>/<key>.npy` file per video (and per paragraph),
for machines without h5py; h5py is imported only where an h5 file is read.
The preload is a plain numpy dict in one process (the reference's shared
arrays served DataLoader worker processes, features_loader.py:49-52).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

VIDEO_SOURCES = ("h5", "npz_activitynet", "npy")
TEXT_SOURCES = ("h5", "npy")


def _h5py():
    import h5py
    return h5py


class VideoFeatureLoader:
    """Load video features from h5, per-video npz or npy (reference :16)."""

    def __init__(self, dataset_path: Union[str, Path], features_name: str,
                 features_source: str, data_keys: List[str], *,
                 preload_vid_feat: bool = False) -> None:
        self.dataset_path = Path(dataset_path)
        self.features_name = features_name
        self.features_source = features_source
        self.data_keys = data_keys
        self.cached_data: Dict[str, np.ndarray] = {}
        self.preload_vid_feat = preload_vid_feat
        if self.features_source not in VIDEO_SOURCES:
            raise NotImplementedError(
                f"Feature source type {self.features_source} "
                f"not understood.")
        self.h5_path = self.dataset_path / f"{self.features_name}.h5"
        self.npz_dir = self.dataset_path / "features" / self.features_name
        self.npy_dir = self.dataset_path / self.features_name

        # per-video frame counts over the FULL store, cached as json
        self.num_frames_file = (
            self.dataset_path / f"{self.features_name}_num_frames.json")
        if not self.num_frames_file.is_file():
            num_frames = {key: int(data.shape[0])
                          for key, data in self.iter_all()}
            self.num_frames_file.write_text(
                json.dumps(num_frames, sort_keys=True), encoding="utf8")
        self.num_frames: Dict[str, int] = json.loads(
            self.num_frames_file.read_text(encoding="utf8"))

        if self.preload_vid_feat:
            for key in self.data_keys:
                self.cached_data[key] = self._load(key)

    def iter_all(self):
        """Yield (key, features (T, D)) for EVERY key in the store."""
        if self.features_source == "h5":
            with _h5py().File(self.h5_path, "r") as h5:
                for key in h5.keys():
                    yield key, h5[key]
        elif self.features_source == "npy":
            for file in sorted(self.npy_dir.glob("*.npy")):
                yield file.stem, np.load(file, mmap_mode="r")
        else:
            for file in os.listdir(self.npz_dir):
                data_key = file[2:-4]  # v_<ytid>.npz -> <ytid>
                yield data_key, self._load_npz(data_key)

    def _load_npz(self, data_key: str) -> np.ndarray:
        """ActivityNet ICEP npz (reference :70-73)."""
        file = self.npz_dir / f"v_{data_key}.npz"
        return np.load(str(file))["frame_scores"].squeeze(1).squeeze(
            2).squeeze(2)

    def _load(self, key: str) -> np.ndarray:
        if self.features_source == "h5":
            with _h5py().File(self.h5_path, "r") as h5:
                return np.asarray(h5[key], dtype=np.float32)
        if self.features_source == "npy":
            return np.load(self.npy_dir / f"{key}.npy").astype(np.float32)
        return self._load_npz(key)

    def __getitem__(self, key: str) -> np.ndarray:
        assert key in self.num_frames or key in self.cached_data, (
            f"Video features for datapoint {key} not found.")
        if key in self.cached_data:
            return self.cached_data[key]
        return self._load(key)


class TextFeaturesLoader:
    """Load paragraph text features + sentence splits (reference :125)."""

    def __init__(self, dataset_path: Union[str, Path], features_name: str,
                 features_source: str, keys: List[str], *,
                 preload_text_feat: bool = False) -> None:
        if features_source not in TEXT_SOURCES:
            raise NotImplementedError(
                f"Text feature source {features_source} not implemented.")
        self.features_source = features_source
        self.features_file = Path(dataset_path) / f"{features_name}.h5"
        self.npy_dir = Path(dataset_path) / features_name
        splits_file = (Path(dataset_path) /
                       f"{features_name}_sentence_splits.json")
        self.data_keys = keys
        self.cached_data: Dict[str, np.ndarray] = {}
        self.preload_text_feat = preload_text_feat
        self.sentence_splits: Dict[str, List[int]] = json.loads(
            splits_file.read_text(encoding="utf8"))

        if self.preload_text_feat:
            for key in self.data_keys:
                self.cached_data[key] = self._load(key)[0]

    def _resolve_key(self, available, key: str) -> str:
        """Legacy `v_<id[:11]>` fallback (reference :152)."""
        if key in available:
            return key
        old_key = f"v_{key[:11]}"
        if old_key in available:
            return old_key
        raise KeyError(f"Key {key} not found in the text features "
                       f"{self.features_file.stem}.")

    def _load(self, key: str) -> Tuple[np.ndarray, str]:
        """(paragraph features, the key they were stored under)."""
        if self.features_source == "npy":
            names = {f.stem for f in self.npy_dir.glob("*.npy")} \
                if not (self.npy_dir / f"{key}.npy").is_file() else {key}
            resolved = self._resolve_key(names, key)
            return (np.load(self.npy_dir / f"{resolved}.npy").astype(
                np.float32), resolved)
        with _h5py().File(self.features_file, "r") as h5:
            resolved = self._resolve_key(h5, key)
            return np.asarray(h5[resolved], dtype=np.float32), resolved

    def __getitem__(self, key: str) -> Tuple[np.ndarray, List[int]]:
        """Returns (paragraph features (T, D), per-sentence token counts)."""
        assert key in self.data_keys, (
            f"Text features for datapoint {key} not found.")
        if key in self.cached_data:
            feats = self.cached_data[key]
            resolved = key if key in self.sentence_splits else f"v_{key[:11]}"
        else:
            feats, resolved = self._load(key)
        if resolved in self.sentence_splits:
            return feats, self.sentence_splits[resolved]
        return feats, self.sentence_splits[f"v_{key[:11]}"]
