"""
How far a caption train trajectory runs apart from a tiny change of its
weights, on the CPU: the reason chip_smoke.py phase 9 holds the
TransformerXL's train steps against the CPU one step at a time
(`hold_train_steps_synced`) and not as a free-running 3-step trajectory
(`hold_train_steps`, phases 7-8).

The phase's setting, on the CPU: yc2_2d3d_coot_vidclip_mart.yaml at full
width, the real YouCook2 caption annotations, COOT embeddings from seed 0
(as chip_smoke.py `_coot_embeddings` writes them); `train_caption --device
cpu --seed 0` trains MART, and the TransformerXL, one epoch on the first
160 train videos (validation off). From each CLI's weights, 3 steps at lr
1e-4 on the first 8 train videos (MART; the TransformerXL with and
without xl_grad), once as trained and once with every weight multiplied
by (1 + 1e-6 * N(0, 1)); prints each step's grad_norm and the relative
difference of the two runs. Float32, dropout 0.1 with the same seeds in
both runs. About 10 minutes on 6 threads.

    python3 coot_videotext_tpu_torch/tools/caption_step_sensitivity.py \\
        [--threads 6]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from coot_videotext_tpu_torch import train_caption  # noqa: E402
from coot_videotext_tpu_torch.data.caption_dataset import (  # noqa: E402
    STACKED_KEYS, RecursiveCaptionDataset)
from coot_videotext_tpu_torch.tasks.caption.config import (  # noqa: E402
    MartConfig)
from coot_videotext_tpu_torch.tasks.caption.model_manager import (  # noqa
    build_mart_model_manager)
from coot_videotext_tpu_torch.tasks.caption.steps import (  # noqa: E402
    caption_train_step, init_caption_train_state)
from coot_videotext_tpu_torch.utils.yaml_utils import (  # noqa: E402
    load_yaml_config_file)

CONFIG = (ROOT / "config" / "caption" / "paper2020" /
          "yc2_2d3d_coot_vidclip_mart.yaml")
ANNOTATIONS = ROOT / "annotations"
CACHE = str(ROOT / "cache_caption")
# (the CLI's overrides, the checks' extra overrides)
MODELS = {"MART": ({}, ({},)),
          "TransformerXL": ({"xl": True}, ({}, {"xl_grad": True}))}
LR = 1e-4
PERTURBATION = 1e-6


def coot_embeddings(out: Path, cfg) -> None:
    """chip_smoke.py `_coot_embeddings`: unit rows from seed 0."""
    rng = np.random.RandomState(0)

    def unit_rows(n, d):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    for split in ("train", "val"):
        data = json.loads((ANNOTATIONS / "youcook2" /
                           f"captioning_{split}.json").read_text())
        clip_num = np.asarray([len(v["timestamps"]) for v in data.values()],
                              np.int64)
        np.savez(out / f"{cfg.coot_model_name}_{split}.npz",
                 key=np.asarray(list(data)), clip_num=clip_num,
                 vid_emb=unit_rows(len(data), cfg.coot_dim_vid),
                 vid_context=unit_rows(len(data), cfg.coot_dim_vid),
                 clip_emb=unit_rows(int(clip_num.sum()), cfg.coot_dim_clip))


def config(over: dict) -> MartConfig:
    cfg = load_yaml_config_file(CONFIG)
    cfg.update(over)
    return MartConfig(cfg)


def three_steps(over: dict, vocab: int, weights, batch, noise: float):
    cfg = config(over)
    mgr = build_mart_model_manager(cfg, vocab, torch.device("cpu"), seed=1,
                                   cache_dir=CACHE)
    gen = torch.Generator().manual_seed(5)
    mgr.load_state({"model": {
        k: v * (1 + noise * torch.randn(v.shape, generator=gen))
        if v.is_floating_point() else v for k, v in weights.items()}})
    state = init_caption_train_state(mgr.model, cfg, 0)
    return [float(caption_train_step(state, batch, LR)["grad_norm"])
            for _ in range(3)]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--threads", type=int, default=6)
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    tmp = Path(tempfile.mkdtemp(prefix="caption_sensitivity_"))
    coot_embeddings(tmp, config({}))
    for name, (cli_over, checks) in MODELS.items():
        cut = ",".join(["dataset_train.max_datapoints=160",
                        "dataset_val.max_datapoints=100",
                        "train.num_epochs=1", "val.val_start=1"]
                       + [f"{k}={str(v).lower()}"
                          for k, v in cli_over.items()])
        result = train_caption.main([
            "-c", str(CONFIG), "--seed", "0", "--device", "cpu",
            "--annotations_dir", str(ANNOTATIONS), "--coot_feat_dir",
            str(tmp), "--cache_dir", CACHE, "--log_dir", str(tmp / name),
            "-o", cut])[0]
        weights = torch.load(result["models_dir"] / "model_0.pth",
                             map_location="cpu", weights_only=True)["model"]
        for extra in checks:
            over = {**cli_over, **extra}
            cfg = config(over)
            data = RecursiveCaptionDataset(
                "youcook2", cfg.max_t_len, cfg.max_v_len, cfg.max_n_sen,
                "train", coot_model_name=cfg.coot_model_name,
                coot_mode=cfg.coot_mode, coot_dim_vid=cfg.coot_dim_vid,
                coot_dim_clip=cfg.coot_dim_clip,
                annotations_dir=str(ANNOTATIONS), coot_feat_dir=str(tmp))
            stacked, _, _ = data.collate_fn([data[i] for i in range(8)])
            batch = {k: torch.from_numpy(stacked[k]) for k in STACKED_KEYS}
            vocab = len(data.word2idx)
            base = three_steps(over, vocab, weights, batch, 0.0)
            moved = three_steps(over, vocab, weights, batch, PERTURBATION)
            rel = [abs(a - b) / a for a, b in zip(base, moved)]
            label = name + (", xl_grad" if extra else "")
            print(f"{label}: grad_norm by step "
                  f"{[round(v, 3) for v in base]}, weights x (1 + "
                  f"{PERTURBATION:g} N(0,1)) {[round(v, 3) for v in moved]}"
                  f": relative {', '.join(f'{r:.2e}' for r in rel)}",
                  flush=True)


if __name__ == "__main__":
    main()
