"""
The system under test for the COOT cells: the program's retrieval model,
optimizer, train state, device metadata and feature source, built on the
benchmark's split and initialised from the run's seed on the device.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from coot_videotext_tpu_torch.data.device_store import (
    FeatureSource, RetrievalDeviceMeta)
from coot_videotext_tpu_torch.models.retrieval import RetrievalModel
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.steps import TrainState
from coot_videotext_tpu_torch.train.optim import make_optimizer

# keys of a configuration file that are the benchmark's, not the program's
BENCH_KEYS = ("assumed", "split", "source_file")


def program_config(cfg: dict) -> RetrievalConfig:
    """The program's config object (it consumes the dict it is given)."""
    return RetrievalConfig(copy.deepcopy(
        {k: v for k, v in cfg.items() if k not in BENCH_KEYS}))


def initial_weights(names_shapes, cfg: dict, seed: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The weights both sides start from, made on the device in one call:
    every Linear and GenPool tensor normal with the configuration's
    weight_init_std, clipped at two stds (its truncnorm init); norm gains 1
    and biases 0."""
    std = float(cfg["net_video_local"]["weight_init_std"])
    total = sum(int(torch.Size(s).numel()) for _, s in names_shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2654435761 + 1) & ((1 << 63) - 1))
    flat = torch.randn(total, generator=gen, device=device) * std
    flat.clamp_(-2 * std, 2 * std)
    out, at = {}, 0
    for name, shape in names_shapes:
        n = int(torch.Size(shape).numel())
        if name.endswith(".gain"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith("normalization.bias") or name.endswith(
                "norm_input.bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = flat[at:at + n].view(shape).clone()
        at += n
    return out


class CootProgram:
    """The program's objects for one run."""

    def __init__(self, cfg: dict, split, seed: int, device: torch.device,
                 batch_size: int, train: bool) -> None:
        self.rc = program_config(cfg)
        ds = self.rc.dataset_train
        self.model = RetrievalModel(self.rc.model_cfgs, ds.vid_feat_dim,
                                    ds.text_feat_dim).to(device)
        named = list(self.model.named_parameters())
        self.weights = initial_weights([(n, p.shape) for n, p in named], cfg,
                                       seed, device)
        with torch.no_grad():
            for n, p in named:
                p.copy_(self.weights[n])
        self.meta = RetrievalDeviceMeta(split.store, split.shapes,
                                        split.max_frames,
                                        batch_size=batch_size,
                                        pack_parts=True)
        noise = (ds.frames_noise, ds.words_noise) if train else (0.0, 0.0)
        self.source = FeatureSource(split.store, self.meta, *noise)
        self.train_dtype = (torch.bfloat16 if self.rc.compute_dtype
                            in ("bfloat16", "float16") else torch.float32)
        self.val_dtype = torch.bfloat16 if self.rc.fp16_val else torch.float32
        self.loss_kw = dict(
            loss_weights=self.rc.train.contrastive_loss_config.as_dict(),
            margin=self.rc.train.contrastive_loss_config.margin,
            loss_cycle_cons=self.rc.train.loss_cycle_cons)
        self.state = None
        if train:
            self.state = TrainState(
                model=self.model,
                optimizer=make_optimizer(self.rc.optimizer, dict(named)),
                seed=philox.seed_state(seed, device))
