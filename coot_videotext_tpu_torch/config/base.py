"""
Strict pop-style typed experiment configs (copy of the config classes of
coot_videotext_tpu/config/base.py; the config keys are shared with the JAX
package so one yaml file drives both).

Config-surface parity with reference nntrainer/trainer_configs.py (the yaml
key names are identical so the reference's config files parse unchanged).
The JAX package's additions (`mesh_shape`, `compute_dtype`, `prng_impl`,
...) are parsed too; the PyTorch package reads `compute_dtype`, `fp16_val`
and `random_seed`.
"""

from __future__ import annotations

import dataclasses
from copy import deepcopy
from typing import Dict, List, Optional

from coot_videotext_tpu_torch import typext
from coot_videotext_tpu_torch.utils import general as utils


@dataclasses.dataclass
class BaseTrainerState(typext.SaveableState):
    """
    Trainer state persisted per epoch as json (JAX config/base.py:27,
    reference trainer_configs.py:11). The val-history lists are how the best
    epoch is found later without an index file.
    """
    time_total: float = 0
    time_val: float = 0
    start_epoch: int = 0
    current_epoch: int = 0
    epoch_step: int = 0
    total_step: int = 0
    det_best_field_current: float = 0
    det_best_field_best: Optional[float] = None
    infos_val_epochs: List[int] = dataclasses.field(default_factory=list)
    infos_val_steps: List[int] = dataclasses.field(default_factory=list)
    infos_val_is_good: List[int] = dataclasses.field(default_factory=list)
    last_grad_norm: float = 0


class BaseExperimentConfig(typext.ConfigClass):
    """
    Loads the full experiment yaml dict; resolves `same_as`; pops the
    technical top-level keys (reference trainer_configs.py:35).
    """

    def __init__(self, config: Dict, strict: bool = True) -> None:
        self.config_orig = deepcopy(config)
        self.config = config
        self.strict = strict
        utils.resolve_sameas_config_recursively(config)
        self.description: str = config.pop("description",
                                           "no description given.")
        self.random_seed: Optional[int] = config.pop("random_seed")
        self.config_type: str = config.pop("config_type")
        # accepted for reference-config compatibility; cuda/cudnn semantics do
        # not exist on TPU. fp16_* select bfloat16 compute.
        self.use_cuda: bool = config.pop("use_cuda", True)
        self.use_multi_gpu: bool = config.pop("use_multi_gpu", False)
        self.cudnn_enabled: bool = config.pop("cudnn_enabled", True)
        self.cudnn_benchmark: bool = config.pop("cudnn_benchmark", True)
        self.cudnn_deterministic: bool = config.pop("cudnn_deterministic",
                                                    False)
        self.cuda_non_blocking: bool = config.pop("cuda_non_blocking", True)
        self.fp16_train: bool = config.pop("fp16_train", False)
        self.fp16_val: bool = config.pop("fp16_val", False)
        # TPU-specific additions
        self.mesh_shape: Optional[Dict[str, int]] = config.pop(
            "mesh_shape", None)
        self.compute_dtype: str = config.pop(
            "compute_dtype", "bfloat16" if self.fp16_train else "float32")
        # device PRNG implementation; None = auto (rbg on TPU — much
        # faster dropout-mask generation — threefry elsewhere)
        self.prng_impl: Optional[str] = config.pop("prng_impl", None)

    def post_init(self) -> None:
        if self.strict:
            utils.check_config_dict(type(self).__name__, self.config)

    def pop_group(self, group_name: str, config_cls):
        """
        Pop a config group and parse it strictly: unlike the reference (which
        only checks leftovers at the TOP level, trainer_configs.py:65-72),
        leftover keys inside each group also raise here — a typo'd
        `train.batch_sizee` fails loudly instead of being silently dropped.
        """
        group = self.config.pop(group_name)
        parsed = config_cls(group)
        if self.strict:
            utils.check_config_dict(f"{type(self).__name__}.{group_name}",
                                    group)
        return parsed


class BaseTrainConfig(typext.ConfigClass):
    """Training group (reference trainer_configs.py:96)."""

    def __init__(self, config: Dict) -> None:
        self.batch_size: int = config.pop("batch_size")
        assert isinstance(self.batch_size, int) and self.batch_size > 0
        self.num_epochs: int = config.pop("num_epochs")
        assert isinstance(self.num_epochs, int) and self.num_epochs > 0
        self.loss_func: str = config.pop("loss_func")
        assert isinstance(self.loss_func, str)
        self.clip_gradient: float = config.pop("clip_gradient")
        assert isinstance(self.clip_gradient, (int, float))
        assert self.clip_gradient >= -1
        # TPU knob (no reference equivalent): scan-fuse K train steps into
        # one dispatch (tasks/retrieval/steps.py make_retrieval_train_scan)
        # when the fully device-resident pipeline is active. 1 = per-step.
        self.steps_per_dispatch: int = config.pop("steps_per_dispatch", 1)
        assert (isinstance(self.steps_per_dispatch, int)
                and self.steps_per_dispatch >= 1)


class BaseValConfig(typext.ConfigClass):
    """Validation group (reference trainer_configs.py:115)."""

    def __init__(self, config: Dict) -> None:
        self.batch_size: int = config.pop("batch_size")
        assert isinstance(self.batch_size, int) and self.batch_size > 0
        self.val_freq: int = config.pop("val_freq")
        assert isinstance(self.val_freq, int) and self.val_freq > 0
        self.val_start: int = config.pop("val_start")
        assert isinstance(self.val_start, int) and self.val_start >= 0
        self.det_best_field: str = config.pop("det_best_field")
        assert isinstance(self.det_best_field, str)
        self.det_best_compare_mode: str = config.pop("det_best_compare_mode")
        assert self.det_best_compare_mode in ("min", "max")
        self.det_best_threshold_mode: str = config.pop(
            "det_best_threshold_mode")
        assert self.det_best_threshold_mode in ("rel", "abs")
        self.det_best_threshold_value: float = config.pop(
            "det_best_threshold_value")
        assert isinstance(self.det_best_threshold_value, (int, float))
        assert self.det_best_threshold_value >= 0
        self.det_best_terminate_after: int = config.pop(
            "det_best_terminate_after")
        assert isinstance(self.det_best_terminate_after, int)
        assert self.det_best_terminate_after >= -1


class BaseSavingConfig(typext.ConfigClass):
    """Checkpoint retention group (reference trainer_configs.py:144)."""

    def __init__(self, config: Dict) -> None:
        self.keep_freq: int = config.pop("keep_freq")
        self.save_last: bool = config.pop("save_last")
        self.save_best: bool = config.pop("save_best")
        self.save_opt_state: bool = config.pop("save_opt_state")
        assert self.keep_freq >= -1


class BaseDatasetConfig(typext.ConfigClass):
    """Dataset group (reference trainer_configs.py:166)."""

    def __init__(self, config: Dict) -> None:
        self.name: str = config.pop("name")
        self.data_type: str = config.pop("data_type")
        self.subset: str = config.pop("subset")
        self.split: str = config.pop("split")
        self.max_datapoints: int = config.pop("max_datapoints")
        self.shuffle: bool = config.pop("shuffle")
        # host pipeline details; pin_memory/num_workers kept for compat (the
        # TPU pipeline uses a prefetch thread instead of worker processes)
        self.pin_memory: bool = config.pop("pin_memory", True)
        self.num_workers: int = config.pop("num_workers", 0)
        self.drop_last: bool = config.pop("drop_last", False)


class BaseLoggingConfig(typext.ConfigClass):
    """Logging cadence group (reference trainer_configs.py:188)."""

    def __init__(self, config: Dict) -> None:
        self.step_train: int = config.pop("step_train")
        self.step_val: int = config.pop("step_val")
        self.step_gpu: int = config.pop("step_gpu")
        self.step_gpu_once: int = config.pop("step_gpu_once")
        assert self.step_train >= -1
        assert self.step_val >= -1
        assert self.step_gpu >= -1
        assert self.step_gpu_once >= -1


# ---------- Optimizer / scheduler configs ----------

class OptimizerConst(typext.ConstantHolder):
    """Optimizer names (reference optimization.py:23)."""
    ADAM = "adam"
    RADAM = "radam"
    SGD = "sgd"


class OptimizerConfig(typext.ConfigClass):
    """Optimizer group (reference optimization.py:23 OptimizerConfig)."""

    def __init__(self, config: Dict) -> None:
        self.name: str = config.pop("name")
        self.lr: float = config.pop("lr")
        self.weight_decay: float = config.pop("weight_decay")
        self.weight_decay_for_bias: bool = config.pop("weight_decay_for_bias")
        self.momentum: float = config.pop("momentum")  # = adam beta1
        self.sgd_nesterov: bool = config.pop("sgd_nesterov", False)
        self.adam_beta2: float = config.pop("adam_beta2")
        self.adam_eps: float = config.pop("adam_eps")
        self.adam_amsgrad: bool = config.pop("adam_amsgrad", False)
        self.radam_degentosgd: bool = config.pop("radam_degentosgd", False)
        self.lr_decay_mult: bool = config.pop("lr_decay_mult", False)


class SchedulerConst(typext.ConstantHolder):
    """Scheduler names (reference lr_scheduler.py)."""
    NONE = "none"
    CONST = "const"
    REDUCE_OPW = "reduce_opw"


class SchedulerWarmupConst(typext.ConstantHolder):
    """Warmup types (reference lr_scheduler.py)."""
    NONE = "none"
    EPOCH = "epoch"
    STEP = "step"


class SchedulerConfig(typext.ConfigClass):
    """LR scheduler group (reference lr_scheduler.py:57)."""

    def __init__(self, config: Dict) -> None:
        self.name: str = config.pop("name")
        self.warmup_type: str = config.pop("warmup_type")
        self.warmup_epochs: int = config.pop("warmup_epochs")
        # reduce-on-plateau fields
        self.rop_factor: float = config.pop("rop_factor", 0.1)
        self.rop_patience: int = config.pop("rop_patience", 10)
        self.rop_cooldown: int = config.pop("rop_cooldown", 0)
        self.rop_min_lr_factor: float = config.pop("rop_min_lr_factor", 0)


