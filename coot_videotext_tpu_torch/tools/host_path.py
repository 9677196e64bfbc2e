#!/usr/bin/env python3
"""
The retrieval host path (features collated on the host, batches copied to
the card) at yc2_2d3d_coot width, through the training CLI, on one CUDA
card:

    python3 coot_videotext_tpu_torch/tools/host_path.py --data DIR \\
        [--root ROOT]

ROOT (default: the checkout that holds this file) is the repository whose
`coot_videotext_tpu_torch` is imported, so that two checkouts can be
compared in turns on one card; DIR holds the generated yc2-like features
(4096-d video, 1536-d text, npy; made on the first run, seed 2) and the
experiment trees. `yc2_2d3d_coot.yaml` (batch 64, bf16, frame noise 0.01)
with `preload_device: false` and dense batches trains one epoch of
VIDEOS videos and validates VAL_VIDEOS; then a run of TRACE_VIDEOS videos
is traced with torch.profiler (chip_smoke.py phase 10a calls `measure`
and `train_once`, also for the slab layout). One JSON line:
- train_videos_per_s, val_videos_per_s: the epoch's train and val
  seconds of the trainerstate (`time_total - time_val`, `time_val`);
- step_ms, step_other_share: the step meter's average total and the share
  of it outside the step (collation, the copy or the wait on the prefetch
  queue), at the epoch's last step;
- copy_ms, copy_overlapped_ms: the traced run's host-to-device copies of
  pinned memory, in all and the part of them that ran while a kernel ran
  on another stream; copy_streams and kernel_streams name the streams.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CONFIG = Path("config") / "retrieval" / "paper2020" / "yc2_2d3d_coot.yaml"
# 5 train steps of 64 and one val batch; 2 steps traced
VIDEOS, VAL_VIDEOS, TRACE_VIDEOS = 320, 64, 128
# empty kernels launched first in the traced run, to be lost in place of
# its own first kernels (utils/profiling.py `warm_trace`; a parent checkout
# passed as --root may not have that module)
TRACE_WARMUP_LAUNCHES = 512


def generate(root: Path, data: Path, num_videos: int, num_val_videos: int,
             seed: int = 2) -> None:
    """The yc2-like features (chip_smoke.py's `_yc2_dataset`)."""
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    ds = load_yaml_config_file(root / CONFIG)["dataset_train"]
    generate_retrieval_dataset(
        data, dataset_name=ds["name"], metadata_name=ds["metadata_name"],
        vid_feat_name=ds["vid_feat_name"],
        text_feat_name=ds["text_feat_name"], num_videos=num_videos,
        num_val_videos=num_val_videos, vid_feat_dim=ds["vid_feat_dim"],
        text_feat_dim=ds["text_feat_dim"], mean_clips=7.7, max_clips=16,
        fps=1.0, mean_duration_sec=320.0, tokens_per_sentence=18, seed=seed,
        feat_format="npy")


def host_config(root: Path, out: Path, layout: str, videos: int) -> Path:
    """yc2_2d3d_coot.yaml on the host path (`layout` dense or slab), npy
    features, the first `videos` train videos, written to out/."""
    import yaml
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = load_yaml_config_file(root / CONFIG)
    cfg["dataset_train"].update(
        vid_feat_source="npy", text_feat_source="npy",
        preload_device=False, pack_transfer=layout == "slab",
        max_datapoints=videos)
    cfg["dataset_val"]["max_datapoints"] = -1
    out.mkdir(parents=True, exist_ok=True)
    path = out / CONFIG.name
    path.write_text(yaml.safe_dump(cfg, sort_keys=False), encoding="utf8")
    return path


def train_once(config: Path, data: Path, log_dir: Path, extra=()) -> dict:
    """One CLI epoch with its validation (`extra`: more CLI flags); the
    trainer's own times."""
    from coot_videotext_tpu_torch import train_retrieval
    result = train_retrieval.main(
        ["-c", str(config), "--data_path", str(data), "--log_dir",
         str(log_dir), "-o", "train.num_epochs=1,val.val_start=0"]
        + list(extra))[0]
    base = result["path_base"]
    state = json.loads((base / "models" / "trainerstate_0.json")
                       .read_text(encoding="utf8"))
    steps = json.loads((base / "metrics" / "metrics_step_0.json")
                       .read_text(encoding="utf8"))
    total = steps["ztime/step_total-avg"][-1][1]
    other = steps["ztime/step_other-avg"][-1][1]
    return {"layout": result["layout"], "steps": len(result["step_losses"]),
            "train_s": state["time_total"] - state["time_val"],
            "val_s": state["time_val"], "step_ms": total * 1e3,
            "step_other_share": other / total}


def copy_overlap(trace_file: Path) -> dict:
    """Host-to-device copies of pinned memory (the batches; pageable
    copies of parameters and scalars are left out) in a Chrome trace, and
    the part of them that overlaps a kernel of another stream (us ->
    ms)."""
    events = json.loads(trace_file.read_text())["traceEvents"]
    copies, kernels = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        stream = e.get("args", {}).get("stream")
        span = (e["ts"], e["ts"] + e["dur"], stream)
        if e.get("cat") == "kernel":
            kernels.append(span)
        elif e.get("cat") == "gpu_memcpy" and \
                "HtoD (Pinned" in e.get("name", ""):
            copies.append(span)
    kernels.sort()
    overlapped = 0.0
    for start, end, stream in copies:
        covered, cursor = 0.0, start
        for k0, k1, k_stream in kernels:
            if k1 <= cursor or k_stream == stream:
                continue
            if k0 >= end:
                break
            lo = max(k0, cursor)
            hi = min(k1, end)
            if hi > lo:
                covered += hi - lo
                cursor = hi
        overlapped += covered
    return {"copy_ms": sum(e - s for s, e, _ in copies) / 1e3,
            "copy_overlapped_ms": overlapped / 1e3,
            "copy_streams": sorted({s for _, _, s in copies}),
            "kernel_streams": sorted({s for _, _, s in kernels})}


def measure(root: Path, data: Path, layout: str, videos: int,
            val_videos: int, trace_videos: int, work: Path) -> dict:
    """The timed epoch and the traced one, as one record."""
    import torch
    if not data.is_dir() or not any(data.iterdir()):
        t0 = time.time()
        generate(root, data, videos, val_videos)
        print(f"generated {videos} + {val_videos} videos in "
              f"{time.time() - t0:.1f} s", flush=True)
    record = train_once(host_config(root, work / "timed", layout, videos),
                        data, work / "timed" / "experiments")
    record.update(train_videos_per_s=videos / record["train_s"],
                  val_videos_per_s=val_videos / record["val_s"])
    config = host_config(root, work / "traced", layout, trace_videos)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_WARMUP_LAUNCHES):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        train_once(config, data, work / "traced" / "experiments")
        torch.cuda.synchronize()
    trace = work / "host_path_trace.json"
    prof.export_chrome_trace(str(trace))
    record.update(copy_overlap(trace))
    return record


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", type=str, default=str(ROOT))
    parser.add_argument("--data", type=str, required=True)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("this measures the card: no CUDA device")
    with tempfile.TemporaryDirectory(prefix="coot_host_path_") as work:
        record = measure(root, Path(args.data), "dense", VIDEOS,
                         VAL_VIDEOS, TRACE_VIDEOS, Path(work))
    record.update(root=str(root), device=torch.cuda.get_device_name(0))
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
