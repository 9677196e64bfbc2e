"""
Extract S3D HowTo100M video features:

    python -m coot_videotext_tpu_torch.extract_100m_features <frames> <out> \\
        [--checkpoint pretrained_models/s3d_howto100m.pth] [--kernel 32] \\
        [--stride 16] [--batch_size 16] \\
        [--layer video_embedding|mixed_5c|video_embedding,mixed_5c] \\
        [--bf16] [--output_format h5|npy] [--device cpu]

Port of extract_100m_features.py :55-141 at the repo root (reference
extract_100m_features.py:54-162) around the port's S3D
(models/s3d.py): the frames of each video (`<frames>/<video>/
frame_%010d.jpg`, 16 FPS, 256 x 256 by default) in windows of `kernel`
frames every `stride` frames, a short tail replaced by the last `kernel`
frames when the video is longer than the kernel, a video shorter than the
kernel one window of its first 16 frames, padded by repeating its last
frame; batches of `batch_size` windows; the `--layer` outputs
concatenated in that order as float32, one row per window.

The output is an h5 file keyed by video where h5py imports
(`--output_format h5`, the default there), else a directory of
`<video>.npy` files (`npy`), the layout of the port's `npy` video feature
source (data/features_loader.py). A rerun skips the videos already
written. Without the checkpoint file the weights come from seed 0
(`init_s3d_weights`), as JAX's come from PRNGKey(0). Runs on the CUDA
device unless `--device cpu` is given; asked for CUDA without a GPU it
raises. PIL is imported only where a jpg is read; `extract_video` takes a
frames array, for callers without jpgs.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from coot_videotext_tpu_torch.models.s3d import (
    S3D, init_s3d_weights, load_s3d_checkpoint)
from coot_videotext_tpu_torch.train_retrieval import resolve_device

LAYERS = ("video_embedding", "mixed_5c")
MIN_FRAMES = 16  # the backbone's space-to-depth and pools need 16
WEIGHTS_SEED = 0


class FramesLoader:
    """`frame_%010d.jpg` directories, one per video (JAX :22)."""

    def __init__(self, input_path) -> None:
        print(f"Checking {input_path} for frames")
        num_frames = {}
        for frame_dir in sorted(os.listdir(input_path)):
            full = Path(input_path) / frame_dir
            if not full.is_dir():
                continue
            num_frames[frame_dir] = sum(
                1 for f in os.listdir(full) if f.endswith(".jpg"))
        print(f"Found {len(num_frames)} videos with "
              f"{sum(num_frames.values())} frames total")
        self.input_path = input_path
        self.num_frames = num_frames

    def get_frames(self, video_id: str) -> np.ndarray:
        """All frames, float32 in [0, 1], (T, H, W, 3)."""
        from PIL import Image
        frames = []
        for n in range(self.num_frames[video_id]):
            file = (Path(self.input_path) / video_id /
                    f"frame_{n + 1:010d}.jpg")
            arr = np.array(Image.open(str(file)))
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, axis=-1)
            frames.append(arr)
        return np.stack(frames).astype(np.float32) / 255.0


def video_windows(frames: np.ndarray, kernel: int, stride: int
                  ) -> List[np.ndarray]:
    """The windows of one video (JAX :109-133)."""
    num_frames = frames.shape[0]
    windows = []
    for pointer in range(0, num_frames, stride):
        single = frames[pointer:pointer + kernel]
        if single.shape[0] < kernel:
            single = frames[-kernel:] if num_frames > kernel else None
        if single is not None:
            windows.append(single)
    if not windows:
        print(f"WARNING: Low amount of data, only {num_frames} frames.")
        short = frames[:MIN_FRAMES]
        if short.shape[0] < MIN_FRAMES:
            pad = np.repeat(short[-1:], MIN_FRAMES - short.shape[0], axis=0)
            short = np.concatenate([short, pad], axis=0)
        windows = [short]
    return windows


@torch.no_grad()
def extract_video(model: S3D, frames: np.ndarray, *, kernel: int,
                  stride: int, batch_size: int, layers: Sequence[str],
                  device: torch.device) -> np.ndarray:
    """(windows, sum of the layers' widths) float32 features of one video's
    frames (T, H, W, 3) in [0, 1]."""
    windows = video_windows(frames, kernel, stride)
    results = []
    for start in range(0, len(windows), batch_size):
        batch = torch.from_numpy(np.stack(windows[start:start + batch_size]))
        # NDHWC -> NCDHW (a view: channels-last-3d strides)
        batch = batch.to(device, non_blocking=True).permute(0, 4, 1, 2, 3)
        out = model(batch)
        results.append(torch.cat([out[name].float() for name in layers],
                                 dim=-1).cpu().numpy())
    return np.concatenate(results, axis=0)


class FeatureWriter:
    """Features by video key: an h5 file (opened for appending) or a
    directory of `<key>.npy` files."""

    def __init__(self, path, output_format: str) -> None:
        self.path = Path(path)
        self.output_format = output_format
        self.h5 = None
        if output_format == "h5":
            import h5py
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.h5 = h5py.File(self.path, "a")
        elif output_format == "npy":
            self.path.mkdir(parents=True, exist_ok=True)
        else:
            raise ValueError(f"unknown output format {output_format}")

    def __contains__(self, key: str) -> bool:
        if self.h5 is not None:
            return key in self.h5
        return (self.path / f"{key}.npy").is_file()

    def write(self, key: str, value: np.ndarray) -> None:
        if self.h5 is not None:
            self.h5[key] = value
        else:
            np.save(self.path / f"{key}.npy", value)

    def close(self) -> None:
        if self.h5 is not None:
            self.h5.close()


def default_output_format() -> str:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "npy"
    return "h5"


def build_model(checkpoint: Optional[str], *, bf16: bool,
                device: torch.device) -> S3D:
    """S3D with the checkpoint's weights where the file exists, else with
    weights from WEIGHTS_SEED. In bfloat16 on the card the convolution weights
    are channels-last-3d, the layout of the windows `extract_video` passes
    (cuDNN took 39.8 against 44.5 ms a batch of 16 that way on an H100,
    where float32 took 82.9 against 76.9 and keeps NCDHW; cudnn.benchmark
    changed neither)."""
    model = S3D(dtype=torch.bfloat16 if bf16 else torch.float32)
    if checkpoint is not None and Path(checkpoint).is_file():
        load_s3d_checkpoint(model, torch.load(checkpoint,
                                              map_location="cpu"))
        print(f"Loaded weights from {checkpoint}")
    else:
        print(f"WARNING: checkpoint {checkpoint} not found, running with "
              f"weights from seed {WEIGHTS_SEED} (feature smoke test "
              "only).")
        init_s3d_weights(model, WEIGHTS_SEED)
    model = model.to(device).eval()
    if bf16 and device.type == "cuda":
        model = model.to(memory_format=torch.channels_last_3d)
    return model


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("frames_path", type=str)
    parser.add_argument("output", type=str,
                        help="h5 file, or directory of <video>.npy files")
    parser.add_argument("--checkpoint", type=str,
                        default="pretrained_models/s3d_howto100m.pth")
    parser.add_argument("--kernel", type=int, default=32)
    parser.add_argument("--stride", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--layer", type=str, default="video_embedding",
                        help="'video_embedding', 'mixed_5c' or a comma "
                             "separated combination")
    parser.add_argument("--bf16", action="store_true",
                        help="run the backbone in bfloat16")
    parser.add_argument("--output_format", choices=("h5", "npy"),
                        default=None,
                        help="h5 where h5py imports, else npy")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    layers = args.layer.split(",")
    for name in layers:
        if name not in LAYERS:
            raise ValueError(f"--layer {name} is not one of {LAYERS}")
    device = resolve_device(args.device)

    print("Load model...")
    model = build_model(args.checkpoint, bf16=args.bf16, device=device)
    frames_loader = FramesLoader(args.frames_path)
    writer = FeatureWriter(args.output,
                           args.output_format or default_output_format())
    written = []
    try:
        for key in frames_loader.num_frames:
            if key in writer:
                continue
            result = extract_video(
                model, frames_loader.get_frames(key), kernel=args.kernel,
                stride=args.stride, batch_size=args.batch_size,
                layers=layers, device=device)
            writer.write(key, result)
            written.append(key)
            print(f"{key}: {result.shape}")
    finally:
        writer.close()
    print("Done!")
    return {"written": written, "output_format": writer.output_format,
            "device": device}


if __name__ == "__main__":
    main()
