"""
Data-parallel retrieval training at 1, 2 and 4 ranks on one host: the
CLI under torchrun over NCCL, on the device-resident path in groups of
K = 4 steps, first held against one rank, then timed.

    python3 coot_videotext_tpu_torch/tools/dp_scaling.py [--worlds 1,2,4]

generates a yc2-like split at yc2_2d3d_coot.yaml width (VIDEOS train and
VAL_VIDEOS val videos, npy features), then for each world size W runs
`torchrun --standalone --nproc_per_node=W -m
coot_videotext_tpu_torch.train_retrieval -c <yaml> --preload_device
--fixed_shapes` (the yaml's global batch, 64, split over the W ranks):

- the check: float32, every dropout and the feature noise at 0, one epoch
  on the first CHECK_VIDEOS train videos and validation. Each W > 1 is
  held against the first W of the list (W = 1): every step's loss, the
  val loss and the val score within CHECK_RTOL relative,
  and rank 0's saved parameters within CHECK_UPDATE_TOL of lr a step
  (the tolerances of chip_smoke.py phase 11b). The tool exits non-zero
  where a W disagrees.
- the speed: the yaml as it is (bfloat16, dropout 0.01), EPOCHS epochs of
  the VIDEOS videos; train videos/s and wall ms per step over epochs 1 ..
  EPOCHS-1 (epoch 0 holds the graph's capture) from the trainer's own
  epoch times (validation excluded), the run's wall seconds and the
  losses of the last epoch.

Prints the cards' names and power limits (nvidia-smi), then one JSON line
per W and run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "config" / "retrieval" / "paper2020" / "yc2_2d3d_coot.yaml"
VIDEOS, VAL_VIDEOS = 640, 64
EPOCHS = 3
K = 4
CHECK_VIDEOS = 192           # 3 global batches of 64
CHECK_RTOL = 1e-4
CHECK_UPDATE_TOL = 0.05      # a share of lr a step
NETS = ("net_video_local", "net_video_global", "net_text_local",
        "net_text_global")


def _config(work: Path, name: str, *, check: bool) -> Path:
    """yc2_2d3d_coot.yaml with npy features and train.steps_per_dispatch
    K, written to work/<name>.yaml; for the check in float32, without
    dropout or noise, on the first CHECK_VIDEOS videos."""
    import yaml
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = load_yaml_config_file(CONFIG)
    cfg["dataset_train"].update(vid_feat_source="npy",
                                text_feat_source="npy")
    cfg["train"]["steps_per_dispatch"] = K
    if check:
        cfg["fp16_train"] = cfg["fp16_val"] = False
        cfg["dataset_train"].update(frames_noise=0, words_noise=0,
                                    max_datapoints=CHECK_VIDEOS)
        for net in NETS:
            for group in ("selfatn_config", "crossatn_config",
                          "pooler_config"):
                if isinstance(cfg[net].get(group), dict) and \
                        "dropout" in cfg[net][group]:
                    cfg[net][group]["dropout"] = 0.0
    path = work / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False), encoding="utf8")
    return path


def _generate(data: Path) -> None:
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    ds = load_yaml_config_file(CONFIG)["dataset_train"]
    generate_retrieval_dataset(
        data, dataset_name=ds["name"], metadata_name=ds["metadata_name"],
        vid_feat_name=ds["vid_feat_name"],
        text_feat_name=ds["text_feat_name"], num_videos=VIDEOS,
        num_val_videos=VAL_VIDEOS, vid_feat_dim=ds["vid_feat_dim"],
        text_feat_dim=ds["text_feat_dim"], mean_clips=7.7, max_clips=16,
        fps=1.0, mean_duration_sec=320.0, tokens_per_sentence=18, seed=3,
        feat_format="npy")


def _torchrun(world: int, config: Path, data: Path, log_dir: Path,
              epochs: int) -> Path:
    """One torchrun of the CLI at `world` ranks; its experiment dir."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", "-m",
           "coot_videotext_tpu_torch.train_retrieval", "-c", str(config),
           "--data_path", str(data), "--log_dir", str(log_dir),
           "--preload_device", "--fixed_shapes",
           "-o", f"train.num_epochs={epochs},val.val_start=0,"
           "saving.keep_freq=1"]
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=1800)
    if done.returncode != 0:
        print(done.stdout[-3000:], done.stderr[-3000:], flush=True)
        raise RuntimeError(f"torchrun at {world} ranks exited with "
                           f"{done.returncode}")
    (models,) = list(log_dir.rglob("models"))
    return models.parent


def _metrics(exp: Path, kind: str, epoch: int) -> dict:
    """The metrics file of `kind` ("step" or "epoch") after `epoch`."""
    return json.loads((exp / "metrics" / f"metrics_{kind}_{epoch}.json"
                       ).read_text(encoding="utf8"))


def _series(metrics: dict, key: str) -> list:
    return [v for _, v in metrics.get(key, [])]


def check(world: int, config: Path, data: Path, work: Path) -> dict:
    """The check run at `world` ranks: its per-step losses, val loss and
    score, and rank 0's parameters."""
    import torch
    exp = _torchrun(world, config, data, work / f"check_w{world}", 1)
    epoch = _metrics(exp, "epoch", 0)
    return {"world": world,
            "loss": _series(_metrics(exp, "step", 0), "train_base/loss"),
            "val": _series(epoch, "val_base/loss")
            + _series(epoch, "val_base/best_field"),
            "params": torch.load(exp / "models" / "model_0.pth",
                                 weights_only=True)}


def hold(got: dict, ref: dict, lr: float) -> dict:
    """`got` against `ref`: the largest relative difference of the losses
    and val numbers, and the largest parameter difference as a share of lr
    a step; raises past the tolerances."""
    rel = 0.0
    for key in ("loss", "val"):
        if len(got[key]) != len(ref[key]) or not ref[key]:
            raise RuntimeError(f"W = {got['world']}: {len(got[key])} {key} "
                               f"values, W = {ref['world']} {len(ref[key])}")
        rel = max([rel] + [abs(a - b) / max(abs(b), 1e-12)
                           for a, b in zip(got[key], ref[key])])
    steps = len(ref["loss"])
    diff = max(float((got["params"][net][k].float()
                      - ref["params"][net][k].float()).abs().max())
               for net in ref["params"] for k in ref["params"][net])
    share = diff / lr / steps
    record = {"world": got["world"], "against": ref["world"],
              "steps": steps,
              "max_rel": rel, "params_share_of_lr": share,
              "loss": got["loss"], "ref_loss": ref["loss"]}
    print(json.dumps({"check": record}), flush=True)
    if rel > CHECK_RTOL or share > CHECK_UPDATE_TOL:
        raise RuntimeError(
            f"W = {got['world']} disagrees with W = {ref['world']}: "
            f"{rel:.3e} relative (limit {CHECK_RTOL}), parameters "
            f"{share:.3%} of lr a step (limit {CHECK_UPDATE_TOL:.0%})")
    return record


def speed(world: int, config: Path, data: Path, work: Path) -> dict:
    """The timed run at `world` ranks; its record."""
    t0 = time.time()
    exp = _torchrun(world, config, data, work / f"w{world}", EPOCHS)
    wall = time.time() - t0

    def state(ep):
        return json.loads((exp / "models" / f"trainerstate_{ep}.json"
                           ).read_text(encoding="utf8"))
    train_s = [(state(ep)["time_total"] - state(ep)["time_val"])
               - (state(ep - 1)["time_total"] - state(ep - 1)["time_val"])
               for ep in range(1, EPOCHS)]
    steps = state(EPOCHS - 1)["total_step"] // EPOCHS
    losses = _series(_metrics(exp, "step", EPOCHS - 1),
                     "train_base/loss")[-steps:]
    return {"world": world, "steps_per_epoch": steps,
            "train_videos_per_s": (EPOCHS - 1) * VIDEOS / sum(train_s),
            "ms_per_step": 1e3 * sum(train_s) / ((EPOCHS - 1) * steps),
            "epoch_train_s": train_s, "run_wall_s": wall,
            "last_epoch_losses": losses}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--worlds", default="1,2,4")
    args = parser.parse_args(argv)
    worlds = [int(w) for w in args.worlds.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    t0 = time.time()  # built once, before the ranks load it
    print(f"kernels {cuda_build.build_library()} in "
          f"{time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="dp_scaling_") as tmp:
        work = Path(tmp)
        t0 = time.time()
        _generate(work / "data")
        print(f"generated {VIDEOS} + {VAL_VIDEOS} videos in "
              f"{time.time() - t0:.1f} s", flush=True)
        check_cfg = _config(work, "check", check=True)
        lr = load_yaml_config_file(check_cfg)["optimizer"]["lr"]
        ref = None
        for world in worlds:
            got = check(world, check_cfg, work / "data", work)
            if ref is None:
                ref = got
            else:
                hold(got, ref, lr)
        speed_cfg = _config(work, "speed", check=False)
        for world in worlds:
            print(json.dumps(speed(world, speed_cfg, work / "data", work)),
                  flush=True)


if __name__ == "__main__":
    main()
