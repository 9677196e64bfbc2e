"""
MART captioning experiment configuration (copy of
coot_videotext_tpu/tasks/caption/config.py; one yaml drives both packages).

Config-surface parity with reference mart/configs_mart.py:33-221 — the
reference caption yamls parse unchanged, model_type inference and validity
asserts reproduced. Every key is parsed; `train_caption` runs every
model family (recurrent MART, xl / xl_grad, untied, mtrans, the joint
single-sentence model, share_wd_cls_weight) with greedy decoding, and
beam search (use_beam, beam_reference_compat) on the recurrent MART
model, on COOT embeddings or raw video features. `recurrent_scan` is a
compile-time lever of the JAX package with the same math; here the step
loop always runs unrolled.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from coot_videotext_tpu_torch import typext
from coot_videotext_tpu_torch.config import base as trainer_configs


class MartPathConst(typext.ConstantHolder):
    """Default caption paths (reference configs_mart.py:12)."""
    CACHE_DIR = "cache_caption"
    COOT_FEAT_DIR = "provided_embeddings"
    ANNOTATIONS_DIR = "annotations"
    VIDEO_FEATURE_DIR = "data/mart_video_feature"
    PPL_DIR = "ppl"


class MartDatasetConfig(trainer_configs.BaseDatasetConfig):
    """Captioning dataset config (reference configs_mart.py:~225)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__(config)
        self.preload: bool = config.pop("preload")


class MartConfig(trainer_configs.BaseExperimentConfig):
    """Full captioning experiment config (reference configs_mart.py:33)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__(config)
        self.name = "config_ret"

        self.train = trainer_configs.BaseTrainConfig(config.pop("train"))
        self.val = trainer_configs.BaseValConfig(config.pop("val"))
        self.dataset_train = MartDatasetConfig(config.pop("dataset_train"))
        self.dataset_val = MartDatasetConfig(config.pop("dataset_val"))
        self.logging = trainer_configs.BaseLoggingConfig(
            config.pop("logging"))
        self.saving = trainer_configs.BaseSavingConfig(config.pop("saving"))

        self.label_smoothing: float = config.pop("label_smoothing")

        self.save_mode: str = config.pop("save_mode")
        self.use_beam: bool = config.pop("use_beam")
        # framework extension (not a reference key): decode beams with
        # the reference's bit-exact beam semantics incl. its two decode
        # bugs (translator.py translate_batch_beam docstring). Default
        # False = the fixed beam — an intentional, documented divergence
        # (PARITY.md §2.4); the beam A/B quantifies the difference.
        self.beam_reference_compat: bool = config.pop(
            "beam_reference_compat", False)
        self.beam_size: int = config.pop("beam_size")
        self.n_best: int = config.pop("n_best")
        self.min_sen_len: int = config.pop("min_sen_len")
        self.max_sen_len: int = config.pop("max_sen_len")
        self.block_ngram_repeat: int = config.pop("block_ngram_repeat")
        self.length_penalty_name: str = config.pop("length_penalty_name")
        self.length_penalty_alpha: float = config.pop(
            "length_penalty_alpha")

        self.max_n_sen: int = config.pop("max_n_sen")
        self.max_n_sen_add_val: int = config.pop("max_n_sen_add_val")
        self.max_t_len: int = config.pop("max_t_len")
        self.max_v_len: int = config.pop("max_v_len")
        self.type_vocab_size: int = config.pop("type_vocab_size")
        self.word_vec_size: int = config.pop("word_vec_size")

        self.coot_model_name: Optional[str] = config.pop("coot_model_name")
        self.coot_dim_clip: int = config.pop("coot_dim_clip")
        self.coot_dim_vid: int = config.pop("coot_dim_vid")
        self.coot_mode: str = config.pop("coot_mode")
        self.video_feature_size: int = config.pop("video_feature_size")

        self.debug: bool = config.pop("debug")

        self.attention_probs_dropout_prob: float = config.pop(
            "attention_probs_dropout_prob")
        self.hidden_dropout_prob: float = config.pop("hidden_dropout_prob")
        self.hidden_size: int = config.pop("hidden_size")
        self.intermediate_size: int = config.pop("intermediate_size")
        self.layer_norm_eps: float = config.pop("layer_norm_eps")
        self.memory_dropout_prob: float = config.pop("memory_dropout_prob")
        self.num_attention_heads: int = config.pop("num_attention_heads")
        self.num_hidden_layers: int = config.pop("num_hidden_layers")
        self.n_memory_cells: int = config.pop("n_memory_cells")
        self.share_wd_cls_weight: bool = config.pop("share_wd_cls_weight")
        self.recurrent: bool = config.pop("recurrent")
        # opt-in (beyond the reference): compile the recursive forward's
        # sentence steps 1..S-1 as ONE nn.scan body instead of S-1
        # unrolled copies — large compile-time win at equal math; the
        # per-step dropout rng derivation differs, so seeded training
        # runs are not bit-comparable across this flag
        self.recurrent_scan: bool = config.pop("recurrent_scan", False)
        self.untied: bool = config.pop("untied")
        self.mtrans: bool = config.pop("mtrans")
        self.xl: bool = config.pop("xl")
        self.xl_grad: bool = config.pop("xl_grad")
        self.use_glove: bool = config.pop("use_glove")
        self.freeze_glove: bool = config.pop("freeze_glove")

        self.ema_decay: float = config.pop("ema_decay")
        self.initializer_range: float = config.pop("initializer_range")
        self.lr: float = config.pop("lr")
        self.lr_warmup_proportion: float = config.pop("lr_warmup_proportion")
        self.infty: int = config.pop("infty", 0)
        self.eps: float = config.pop("eps", 1e-6)

        # max joint sequence length (reference :174)
        self.max_position_embeddings: int = self.max_v_len + self.max_t_len
        # set later from the dataset vocabulary
        self.vocab_size: Optional[int] = None

        if self.xl:
            assert self.recurrent, (
                "the TransformerXL variant only exists as a recurrent "
                "model: set recurrent=true alongside xl=true")
        if self.xl_grad:
            assert self.xl, ("xl_grad selects the gradient-carrying XL "
                             "memory and needs xl=true")
        assert not (self.recurrent and self.untied)
        assert not (self.recurrent and self.mtrans)
        assert not (self.untied and self.mtrans)
        if self.share_wd_cls_weight:
            assert self.word_vec_size == self.hidden_size, (
                "tying the classifier to the word embedding requires "
                "word_vec_size == hidden_size")

        # model_type inference (reference :193-207)
        if self.recurrent:
            if self.xl:
                self.model_type = "xl_grad" if self.xl_grad else "xl"
            else:
                self.model_type = "re"
        else:
            if self.untied:
                self.model_type = "untied_single"
            elif self.mtrans:
                self.model_type = "mtrans_single"
            else:
                self.model_type = "single"

        self.post_init()


class MartMetersConst(typext.ConstantHolder):
    """Caption meter names (reference configs_mart.py:~214)."""
    TRAIN_LOSS_PER_WORD = "train/loss_word"
    TRAIN_ACC = "train/acc"
    VAL_LOSS_PER_WORD = "val/loss_word"
    VAL_ACC = "val/acc"
    GRAD = "train/grad"
