"""
Synthetic retrieval dataset generator producing the exact on-disk layout the
loaders expect (meta_<name>.json + video_feat_<name>.h5 + text_feat_<name>.h5
+ sentence_splits json, matching reference coot/features_loader.py and
data_read_youcook2_meta.py outputs), and the synthetic caption set
(`generate_caption_dataset`).

Copy of coot_videotext_tpu/data/synthetic.py::generate_retrieval_dataset:
the same seed gives byte-identical files, so the PyTorch package and the JAX
package can be held against each other on one generated dataset.
`generate_caption_video_features` adds raw MART video features to a
caption set. `RETRIEVAL_PRESETS` and `generate_preset` hold the parameters
of the repo-root scripts data_gen_yc2like.py and data_gen_yc2big.py (the
port's own: coot_videotext_tpu_torch/data_gen_{yc2like,yc2big}.py).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np


# the yc2-scale datasets of the repo-root scripts (YouCook2 "2d3d" widths
# and clip statistics): yc2like at 1/6 of the reference's split sizes,
# yc2big at its full 1333 / 457 videos with noised modalities
_YC2 = dict(vid_feat_name="video_feat_2d3d", vid_feat_dim=4096,
            text_feat_dim=1536, mean_clips=7.7, max_clips=16, fps=1.0,
            mean_duration_sec=320.0, tokens_per_sentence=18, seed=0)
RETRIEVAL_PRESETS = {
    "yc2like": dict(_YC2, dataset_name="yc2like",
                    text_feat_name="text_feat_yc2like", num_videos=192,
                    num_val_videos=48),
    "yc2big": dict(_YC2, dataset_name="yc2big",
                   text_feat_name="text_feat_yc2big", num_videos=1333,
                   num_val_videos=457, signal_scale=0.55,
                   modality_noise=0.7),
}


def default_feat_format() -> str:
    """h5 where h5py is installed, the npy source otherwise."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "npy"
    return "h5"


def generate_preset(name: str, root: Union[str, Path], *,
                    feat_format: Optional[str] = None,
                    **overrides) -> Dict[str, str]:
    """The dataset of RETRIEVAL_PRESETS[name] under root/<dataset_name>/
    (`overrides` replace preset parameters, e.g. fewer videos); returns
    the config overrides, with the feature source."""
    params = dict(RETRIEVAL_PRESETS[name], **overrides)
    params["feat_format"] = feat_format or default_feat_format()
    return generate_retrieval_dataset(root, **params)


class _NpyDir:
    """Directory of `<key>.npy` files with the h5py-File writes used here."""

    def __init__(self, path: Path) -> None:
        self.path = path
        path.mkdir(parents=True, exist_ok=True)

    def __setitem__(self, key: str, value: np.ndarray) -> None:
        np.save(self.path / f"{key}.npy", value)

    def close(self) -> None:
        pass


def generate_retrieval_dataset(
        root: Union[str, Path], *,
        dataset_name: str = "synth",
        metadata_name: str = "all",
        vid_feat_name: str = "video_feat_synth",
        text_feat_name: str = "text_feat_synth",
        num_videos: int = 32,
        num_val_videos: int = 8,
        vid_feat_dim: int = 64,
        text_feat_dim: int = 48,
        mean_clips: float = 4.0,
        max_clips: int = 8,
        fps: float = 2.0,
        mean_duration_sec: float = 120.0,
        tokens_per_sentence: int = 12,
        seed: int = 0,
        shared_projections: bool = True,
        signal_scale: float = 1.0,
        modality_noise: float = 0.0,
        feat_format: str = "h5") -> Dict[str, str]:
    """
    Create a complete synthetic retrieval dataset under root/<dataset_name>/.
    Paired video clips and sentences share a latent vector so retrieval
    metrics are learnable (loss decreases, R@1 >> chance after training).

    shared_projections: draw the latent->feature projections ONCE for the
    whole dataset (default). This makes the cross-modal correspondence a
    single global linear map the model can generalize to held-out videos
    — required for any quality comparison on val retrieval metrics. With
    False (the pre-round-2 behavior) each video gets its own random
    projections: features still carry per-clip latent structure, but
    cross-modal val retrieval is information-theoretically stuck at
    chance, which silently hides quality regressions.

    signal_scale: multiplies the latent contribution added on top of the
    unit-variance feature noise (per-coordinate signal variance ~=
    signal_scale^2). 1.0 (default, stream/byte-identical to earlier
    datasets) saturates R@1 on small val sets; lower it to hold val
    retrieval in the mid-range so quality deltas are visible — used by
    the reference-scale A/B dataset (data_gen_yc2big.py).

    modality_noise: rho>0 gives each modality an independently-noised
    copy of every clip latent (lat + rho*eps), capping retrieval by
    latent geometry instead of feature noise. Unlike signal_scale (whose
    noise pooling averages away — ANY learnable signal saturates R@1),
    this bound is intrinsic to the data: it cannot be trained or
    averaged around, so val metrics land mid-range and implementation
    quality differences stay visible. 0 (default) = legacy perfect
    correspondence, byte-identical streams.

    feat_format: "h5" (one file per modality, as the real datasets) or
    "npy" (one `<feat_name>/<key>.npy` per video and paragraph, for machines
    without h5py); the values are the same either way.

    Returns a dict of config overrides for RetrievalDatasetConfig.
    """
    if feat_format not in ("h5", "npy"):
        raise ValueError(f"feat_format must be h5 or npy, got {feat_format}")
    rng = np.random.RandomState(seed)
    path = Path(root) / dataset_name
    path.mkdir(parents=True, exist_ok=True)

    # drawn only in shared mode so shared_projections=False reproduces the
    # pre-round-2 RNG stream byte-for-byte at a given seed
    shared_proj_v = shared_proj_t = None
    if shared_projections:
        shared_proj_v = rng.randn(16, vid_feat_dim).astype(np.float32) / 4
        shared_proj_t = rng.randn(16, text_feat_dim).astype(np.float32) / 4

    total = num_videos + num_val_videos
    meta = {}
    if feat_format == "h5":
        import h5py
        vid_store = h5py.File(path / f"{vid_feat_name}.h5", "w")
        text_store = h5py.File(path / f"{text_feat_name}.h5", "w")
    else:
        vid_store = _NpyDir(path / vid_feat_name)
        text_store = _NpyDir(path / text_feat_name)
    sentence_splits: Dict[str, list] = {}

    for i in range(total):
        key = f"video{i:04d}"
        split = "train" if i < num_videos else "val"
        n_clips = int(np.clip(rng.poisson(mean_clips - 1) + 1, 1, max_clips))
        duration = max(20.0, rng.normal(mean_duration_sec,
                                        mean_duration_sec / 4))
        num_frames = int(duration * fps)

        # shared latent per clip drives both modalities
        latents = rng.randn(n_clips, 16).astype(np.float32)
        # Imperfect cross-modal correspondence: each modality sees an
        # independently-noised copy of the clip latent, so retrieval is
        # bounded by latent geometry rather than feature noise (which
        # pooling averages away at ANY signal_scale — real captions
        # likewise never describe everything in the frame). rho=0.7 puts
        # the 457-video v2p R@1 ceiling ~0.50 / c2s ~0.27, the real
        # yc2_2d3d regime. Drawn only when enabled so legacy datasets
        # stay byte-reproducible at a given seed.
        if modality_noise > 0:
            lat_v = latents + modality_noise * rng.randn(
                n_clips, 16).astype(np.float32)
            lat_t = latents + modality_noise * rng.randn(
                n_clips, 16).astype(np.float32)
        else:
            lat_v = lat_t = latents
        if shared_projections:
            proj_v, proj_t = shared_proj_v, shared_proj_t
        else:
            proj_v = rng.randn(16, vid_feat_dim).astype(np.float32) / 4
            proj_t = rng.randn(16, text_feat_dim).astype(np.float32) / 4

        vid_feat = rng.randn(num_frames, vid_feat_dim).astype(np.float32)
        bounds = np.sort(rng.choice(
            np.arange(1, num_frames - 1), size=max(n_clips - 1, 0),
            replace=False)) if n_clips > 1 else np.array([], int)
        seg_starts = np.concatenate([[0], bounds]).astype(int)
        seg_stops = np.concatenate([bounds, [num_frames]]).astype(int)

        segments = []
        splits = []
        text_rows = []
        for c in range(n_clips):
            s, e = int(seg_starts[c]), int(seg_stops[c])
            vid_feat[s:e] += signal_scale * (lat_v[c] @ proj_v)
            t0, t1 = s / fps, e / fps
            segments.append({
                "text": f"synthetic sentence {i} {c} doing things.",
                "start_sec": float(t0), "stop_sec": float(t1)})
            n_tok = tokens_per_sentence
            rows = rng.randn(n_tok, text_feat_dim).astype(np.float32)
            rows += signal_scale * (lat_t[c] @ proj_t)
            text_rows.append(rows)
            splits.append(n_tok)

        meta[key] = {
            "data_key": key,
            "split": split,
            "duration_sec": float(duration),
            "segments": segments,
        }
        vid_store[key] = vid_feat
        text_store[key] = np.concatenate(text_rows, axis=0)
        sentence_splits[key] = splits

    vid_store.close()
    text_store.close()
    (path / f"meta_{metadata_name}.json").write_text(
        json.dumps(meta), encoding="utf8")
    (path / f"{text_feat_name}_sentence_splits.json").write_text(
        json.dumps(sentence_splits), encoding="utf8")

    return {
        "name": dataset_name,
        "metadata_name": metadata_name,
        "vid_feat_name": vid_feat_name,
        "vid_feat_source": feat_format,
        "vid_feat_dim": vid_feat_dim,
        "text_feat_name": text_feat_name,
        "text_feat_source": feat_format,
        "text_feat_dim": text_feat_dim,
    }


def generate_caption_dataset(
        root: Union[str, Path], *,
        dset_name: str = "youcook2",
        coot_model_name: str = "synthcoot",
        num_videos: int = 16,
        num_val_videos: int = 8,
        coot_dim_vid: int = 64,
        coot_dim_clip: int = 32,
        mean_sentences: float = 3.0,
        max_sentences: int = 5,
        vocab_words: int = 40,
        seed: int = 0,
        emb_format: Optional[str] = None) -> Dict[str, str]:
    """
    Create a synthetic captioning setup: annotation jsons
    (captioning_train/val.json + *_para.json GT + mart_word2idx.json) under
    root/annotations/<dset>/ and a COOT-embedding h5 (the retrieval
    trainer's export schema) under root/provided_embeddings/. Captions are
    drawn from a small vocabulary correlated with the clip latent so the
    model can learn. Copy of the JAX package's generate_caption_dataset:
    the same seed gives the same files. `emb_format` "h5" or "npz" (the
    same arrays); by default h5 where h5py is installed, else npz.

    Refuses to overwrite an annotations dir it did not create itself (a
    `.synthetic` marker identifies generator output): with root="." and
    the default dset_name this would silently clobber the REAL shipped
    annotations/youcook2 files. Point root at a scratch dir (e.g.
    data/capsmoke) and pass --annotations_dir/--coot_feat_dir to
    train_caption instead.
    """
    if emb_format is None:
        try:
            import h5py  # noqa: F401
            emb_format = "h5"
        except ImportError:
            emb_format = "npz"
    rng = np.random.RandomState(seed)
    ann_dir = Path(root) / "annotations" / dset_name
    emb_dir = Path(root) / "provided_embeddings"
    marker = ann_dir / ".synthetic"
    if ann_dir.is_dir() and any(ann_dir.glob("captioning_*.json")) \
            and not marker.exists():
        raise RuntimeError(
            f"{ann_dir} holds annotation files not written by this "
            "generator (e.g. the real shipped youcook2 annotations); "
            "refusing to overwrite. Use a scratch root directory.")
    ann_dir.mkdir(parents=True, exist_ok=True)
    emb_dir.mkdir(parents=True, exist_ok=True)
    marker.write_text("generate_caption_dataset output\n",
                      encoding="utf8")

    # one global latent->embedding map (like generate_retrieval_dataset's
    # shared_projections): with per-video projections the caption words,
    # which are derived from the clip latent, are unlearnable from the
    # embeddings on held-out videos — degenerate decodes zero out CIDEr
    shared_proj_v = rng.randn(8, coot_dim_vid).astype(np.float32) / 3
    shared_proj_c = rng.randn(8, coot_dim_clip).astype(np.float32) / 3

    words = [f"word{i}" for i in range(vocab_words)]
    word2idx = {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[VID]": 3,
                "[BOS]": 4, "[EOS]": 5, "[UNK]": 6}
    for w in words + ["the", "a", "person", "adds", "cuts", "."]:
        word2idx.setdefault(w, len(word2idx))
    (ann_dir / "mart_word2idx.json").write_text(json.dumps(word2idx),
                                                encoding="utf8")

    def make_split(n, split, offset):
        data = {}
        keys, clip_nums = [], []
        vid_embs, ctx_embs, clip_embs = [], [], []
        for i in range(n):
            vid = f"synthvid{offset + i:04d}"
            n_sen = int(np.clip(rng.poisson(mean_sentences - 1) + 1, 1,
                                max_sentences))
            duration = 20.0 * n_sen
            bounds = np.linspace(0, duration, n_sen + 1)
            timestamps = [[float(bounds[j]), float(bounds[j + 1])]
                          for j in range(n_sen)]
            latents = rng.randn(n_sen, 8).astype(np.float32)
            sentences = []
            for j in range(n_sen):
                picks = [words[int(abs(latents[j, k]) * 7) % vocab_words]
                         for k in range(4)]
                sentences.append("the person " + " ".join(picks) + " .")
            data[vid] = {"duration": duration,
                         "timestamps": timestamps,
                         "sentences": sentences}
            keys.append(vid)
            clip_nums.append(n_sen)
            vid_embs.append(latents.mean(0) @ shared_proj_v)
            ctx_embs.append(latents.mean(0) @ shared_proj_c)
            for j in range(n_sen):
                clip_embs.append(latents[j] @ shared_proj_c)
        ann_name = ("captioning_train.json" if split == "train"
                    else "captioning_val.json")
        (ann_dir / ann_name).write_text(json.dumps(data), encoding="utf8")
        if split == "val":
            para = {k: " ".join(v["sentences"]).replace(" .", ".")
                    for k, v in data.items()}
            (ann_dir / "captioning_val_para.json").write_text(
                json.dumps(para), encoding="utf8")
        arrays = {"clip_num": np.asarray(clip_nums, np.int64),
                  "vid_emb": np.stack(vid_embs),
                  "vid_context": np.stack(ctx_embs),
                  "clip_emb": np.stack(clip_embs)}
        stem = emb_dir / f"{coot_model_name}_{split}"
        if emb_format == "npz":
            np.savez(stem.with_suffix(".npz"), key=np.asarray(keys),
                     **arrays)
        else:
            import h5py
            with h5py.File(stem.with_suffix(".h5"), "w") as h5:
                h5["key"] = keys
                for name, value in arrays.items():
                    h5[name] = value
        return data

    make_split(num_videos, "train", 0)
    make_split(num_val_videos, "val", num_videos)
    return {
        "annotations_dir": str(Path(root) / "annotations"),
        "coot_feat_dir": str(emb_dir),
        "coot_model_name": coot_model_name,
        "coot_dim_vid": coot_dim_vid,
        "coot_dim_clip": coot_dim_clip,
        "vocab_size": len(word2idx),
    }



def generate_caption_video_features(
        root: Union[str, Path], *,
        dset_name: str = "youcook2",
        dim_resnet: int = 12,
        dim_bn: int = 8,
        seed: int = 0) -> Dict[str, object]:
    """
    Raw MART video features for the caption annotations under
    root/annotations/<dset>/ (captioning_train.json, then
    captioning_val.json): per video `{vid}_resnet.npy` (T, dim_resnet) and
    `{vid}_bn.npy` (T, dim_bn), float32, under root/video_features/<dset>/,
    and the frame<->second table `captioning_video_feat_duration.csv`
    (lines `name,duration_sec,num_frames`) in the annotations dir. T is
    2 rows a second of the video's duration, so the YouCook2 table
    resolves to 0.5 s a row and every annotated timestamp indexes inside
    the file; rows inside sentence j's timestamp share a per-sentence
    latent. Copy of the JAX package's generate_caption_video_features: the
    same annotations and seed give the same files.

    Refuses to overwrite a duration table that a generator did not write
    (one without a `.synthetic` marker beside it, as the repo's real
    annotations are).
    """
    rng = np.random.RandomState(seed + 17)
    ann_dir = Path(root) / "annotations" / dset_name
    feat_dir = Path(root) / "video_features" / dset_name
    csv_file = ann_dir / "captioning_video_feat_duration.csv"
    marker = ann_dir / ".synthetic"
    if csv_file.exists() and not marker.exists():
        raise RuntimeError(
            f"{csv_file} was not written by a generator (e.g. the real "
            "shipped table); refusing to overwrite. Copy the annotations "
            "to a scratch root directory.")
    feat_dir.mkdir(parents=True, exist_ok=True)
    marker.write_text("generator output\n", encoding="utf8")

    proj_r = rng.randn(8, dim_resnet).astype(np.float32) / 3
    proj_b = rng.randn(8, dim_bn).astype(np.float32) / 3

    csv_lines = []
    for ann_name in ("captioning_train.json", "captioning_val.json"):
        data = json.loads((ann_dir / ann_name).read_text(encoding="utf8"))
        for vid, meta in data.items():
            duration = float(meta["duration"])
            num_frames = int(round(duration * 2))  # 2 rows a second
            csv_lines.append(f"{vid},{duration},{num_frames}")
            # each row's latent is that of the sentence covering it
            bounds = np.asarray([t[1] for t in meta["timestamps"]])
            t_frame = (np.arange(num_frames) + 0.5) * 0.5
            sen_idx = np.searchsorted(bounds, t_frame).clip(
                0, len(bounds) - 1)
            latents = rng.randn(len(bounds), 8).astype(np.float32)
            frame_lat = latents[sen_idx]
            noise = 0.05 * rng.randn(num_frames, 8).astype(np.float32)
            np.save(feat_dir / f"{vid}_resnet.npy",
                    (frame_lat + noise) @ proj_r)
            np.save(feat_dir / f"{vid}_bn.npy",
                    (frame_lat - noise) @ proj_b)
    csv_file.write_text("\n".join(csv_lines), encoding="utf8")
    return {
        "video_feature_dir": str(Path(root) / "video_features"),
        "video_feature_size": dim_resnet + dim_bn,
    }

def _main() -> None:
    """CLI: generate a synthetic retrieval dataset on disk.

    Example: python -m coot_videotext_tpu_torch.data.synthetic data --name synth
    """
    import argparse
    parser = argparse.ArgumentParser(description=_main.__doc__)
    parser.add_argument("root", type=str, help="data root directory")
    parser.add_argument("--name", type=str, default="synth")
    parser.add_argument("--num_videos", type=int, default=32)
    parser.add_argument("--num_val_videos", type=int, default=8)
    parser.add_argument("--vid_feat_dim", type=int, default=64)
    parser.add_argument("--text_feat_dim", type=int, default=48)
    parser.add_argument("--mean_clips", type=float, default=4.0)
    parser.add_argument("--max_clips", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    overrides = generate_retrieval_dataset(
        args.root, dataset_name=args.name,
        num_videos=args.num_videos, num_val_videos=args.num_val_videos,
        vid_feat_dim=args.vid_feat_dim, text_feat_dim=args.text_feat_dim,
        mean_clips=args.mean_clips, max_clips=args.max_clips,
        seed=args.seed)
    print(f"Generated synthetic dataset: {overrides}")


if __name__ == "__main__":
    _main()

