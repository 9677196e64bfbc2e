"""
Retrieval (COOT) experiment configuration (copy of
coot_videotext_tpu/tasks/retrieval/config.py; one yaml drives both packages).

Config-surface parity with reference coot/configs_retrieval.py:14-189; the
reference's yaml files parse unchanged, the JAX package's additions
(static-shape, device-store and transfer knobs) included. The PyTorch
package reads `pad_fixed_shapes`, `preload_device`, `sample_on_device`,
`pack_parts` and `pack_transfer` (data/retrieval_dataset.py) and
`steps_per_dispatch` (tasks/retrieval/trainer.py: groups of K steps, each a
replay of a CUDA graph of the step on the card).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from coot_videotext_tpu_torch import typext
from coot_videotext_tpu_torch.config import base as trainer_configs
from coot_videotext_tpu_torch.config.base import OptimizerConfig, SchedulerConfig
from coot_videotext_tpu_torch.models.configs import TransformerConfig
from coot_videotext_tpu_torch.utils.general import LOGGER_NAME
from coot_videotext_tpu_torch.utils.general import ConfigNamesConst as Conf


class LossesConst(typext.ConstantHolder):
    CONTRASTIVE = "contrastive"
    CROSSENTROPY = "crossentropy"


class ContrastiveLossConfig(typext.ConfigClass):
    """Contrastive loss weights (reference loss_fn.py:33)."""

    def __init__(self, config: Dict) -> None:
        self.margin: float = config.pop("margin")
        self.weight_high: float = config.pop("weight_high")
        self.weight_high_internal: float = config.pop("weight_high_internal")
        self.weight_low: float = config.pop("weight_low")
        self.weight_low_internal: float = config.pop("weight_low_internal")
        self.weight_context: float = config.pop("weight_context")
        self.weight_context_internal: float = config.pop(
            "weight_context_internal")

    def as_dict(self) -> Dict[str, float]:
        return {
            "weight_high": self.weight_high,
            "weight_high_internal": self.weight_high_internal,
            "weight_low": self.weight_low,
            "weight_low_internal": self.weight_low_internal,
            "weight_context": self.weight_context,
            "weight_context_internal": self.weight_context_internal,
        }


class RetrievalConfig(trainer_configs.BaseExperimentConfig):
    """Full retrieval experiment config (reference configs_retrieval.py:14)."""

    def __init__(self, config: Dict[str, Any], *,
                 is_train: bool = True) -> None:
        super().__init__(config)
        self.name = "config_ret"
        self.dim_feat_global: int = config.pop("dim_feat_global", 768)
        self.dim_feat_local: int = config.pop("dim_feat_local", 384)
        if not is_train:
            logger = logging.getLogger(LOGGER_NAME)
            logger.debug("Disable dataset caching during validation.")
            config["dataset_val"]["preload_vid_feat"] = False
            config["dataset_val"]["preload_text_feat"] = False
        self.train = self.pop_group(Conf.TRAIN, RetrievalTrainConfig)
        self.val = self.pop_group(Conf.VAL, RetrievalValConfig)
        self.dataset_train = self.pop_group(Conf.DATASET_TRAIN,
                                            RetrievalDatasetConfig)
        self.dataset_val = self.pop_group(Conf.DATASET_VAL,
                                          RetrievalDatasetConfig)
        self.logging = self.pop_group(Conf.LOGGING,
                                      trainer_configs.BaseLoggingConfig)
        self.saving = self.pop_group(Conf.SAVING,
                                     trainer_configs.BaseSavingConfig)
        self.optimizer = self.pop_group(Conf.OPTIMIZER, OptimizerConfig)
        self.lr_scheduler = self.pop_group(Conf.LR_SCHEDULER,
                                           SchedulerConfig)
        # the network names live beside the model, as in the JAX package
        from coot_videotext_tpu_torch.models.retrieval import (
            RetrievalNetworksConst)
        self.model_cfgs: Dict[str, TransformerConfig] = {}
        for key in RetrievalNetworksConst.values():
            self.model_cfgs[key] = self.pop_group(key, TransformerConfig)
        self.post_init()


class RetrievalValConfig(trainer_configs.BaseValConfig):
    """Retrieval validation config (reference :57)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__(config)
        self.val_clips: bool = config.pop("val_clips")
        assert isinstance(self.val_clips, bool)
        self.val_clips_freq: int = config.pop("val_clips_freq")
        assert isinstance(self.val_clips_freq, int)
        self.save_embeddings: bool = config.pop("save_embeddings", False)


class RetrievalTrainConfig(trainer_configs.BaseTrainConfig):
    """Retrieval train config (reference :73)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__(config)
        self.loss_cycle_cons: float = config.pop("loss_cycle_cons")
        loss_config = config.pop("contrastive_loss_config")
        if self.loss_func == LossesConst.CONTRASTIVE:
            self.contrastive_loss_config = ContrastiveLossConfig(loss_config)


class RetrievalDatasetConfig(trainer_configs.BaseDatasetConfig):
    """Retrieval dataset config (reference :99)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__(config)
        self.metadata_name: str = config.pop("metadata_name")
        self.vid_feat_name: str = config.pop("vid_feat_name")
        self.vid_feat_source: str = config.pop("vid_feat_source")
        self.vid_feat_dim: int = config.pop("vid_feat_dim")
        self.text_feat_name: str = config.pop("text_feat_name")
        self.text_feat_source: str = config.pop("text_feat_source")
        self.text_feat_dim: int = config.pop("text_feat_dim")
        self.min_frames: int = config.pop("min_frames")  # unused (parity)
        self.max_frames: int = config.pop("max_frames")
        self.use_clips: bool = config.pop("use_clips")  # unused (parity)
        self.min_clips: int = config.pop("min_clips")  # unused (parity)
        self.max_clips: int = config.pop("max_clips")  # unused (parity)
        self.include_background: bool = config.pop(
            "include_background")  # unused (parity)
        self.add_stop_frame: int = config.pop("add_stop_frame")
        self.expand_segments: int = config.pop("expand_segments")
        self.frames_noise: float = config.pop("frames_noise")
        self.words_noise: float = config.pop("words_noise")
        self.text_preprocessing: str = config.pop("text_preprocessing")
        self.preload_vid_feat: bool = config.pop("preload_vid_feat")
        self.preload_text_feat: bool = config.pop("preload_text_feat")
        # TPU static-shape knobs
        self.pad_max_clips: int = config.pop("pad_max_clips", -1)
        self.pad_max_sent_tokens: int = config.pop("pad_max_sent_tokens", -1)
        self.pad_max_par_tokens: int = config.pop("pad_max_par_tokens", -1)
        # True: pad all batches to dataset-level static dims (one XLA
        # compile); False: per-batch bucketed shapes (a handful of compiles,
        # less padding compute)
        self.pad_fixed_shapes: bool = config.pop("pad_fixed_shapes", False)
        # HBM-resident feature store: "auto" uploads the whole feature set
        # to device memory when it fits (<6GB) and ships only gather
        # indices per batch; true/false force. The TPU-native analog of the
        # reference's RAM preload.
        self.preload_device = config.pop("preload_device", "auto")
        # with the device store + fixed shapes: also upload the segment
        # metadata and run frame sampling on device (host ships only
        # datapoint ids). Train jitter then uses the jax PRNG (same
        # distribution as the reference's numpy jitter, different stream).
        self.sample_on_device: bool = config.pop("sample_on_device", True)
        # with device sampling: pack valid clips/sentences to the front of
        # a (P, L) layout (P = static overflow-safe budget) so the local
        # nets skip padded part slots entirely (~2x fewer rows on yc2)
        self.pack_parts: bool = config.pop("pack_parts", True)
        # without the device store: ship packed feature-row slabs + gather
        # indices per batch instead of dense zero-padded tensors (~4x
        # fewer host->device bytes, bit-exact — data/retrieval_dataset.py
        # collate_slab). "auto" = on when an accelerator is attached.
        self.pack_transfer = config.pop("pack_transfer", "auto")
        assert self.data_type == ExperimentTypesConst.RETRIEVAL
        assert self.frames_noise >= 0 and self.words_noise >= 0


class ExperimentTypesConst(typext.ConstantHolder):
    RETRIEVAL = "retrieval"
    CAPTION = "caption"


class CootMetersConst(typext.ConstantHolder):
    """Retrieval meter names (reference :169)."""
    TRAIN_LOSS_CC = "train/loss_cc"
    TRAIN_LOSS_CONTRASTIVE = "train/loss_contr"
    VAL_LOSS_CC = "val/loss_cc"
    VAL_LOSS_CONTRASTIVE = "val/loss_contr"
    RET_MODALITIES = ["vid2par", "par2vid", "cli2sen", "sen2cli"]
    RET_MODALITIES_SHORT = ["v2p", "p2v", "c2s", "s2c"]
    RET_METRICS = ["r1", "r5", "r10", "r50", "medr", "meanr"]


