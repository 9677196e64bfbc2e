"""
Metrics plumbing: named AverageMeters with per-meter settings and per-epoch
json storage, with the metric-name constants of the results tooling.

Port of coot_videotext_tpu/utils/metrics.py (schema parity with reference
nntrainer/metric.py): the metric names, the (step, value) / (epoch, value)
storage-list json format and the file names are the JAX trainer's, so the
same tooling reads either package's experiment directories. The
tensorboard sink is left out: the json files hold the same series.
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

from coot_videotext_tpu_torch.typext import ConstantHolder
from coot_videotext_tpu_torch.utils.general import LOGGER_NAME


class PrintGroupConst(ConstantHolder):
    """Column groups of the results tables (utils/view_results.py)."""
    BASE = "base"
    PROFILE = "profile"
    PERFORMANCE = "performance"


class DefaultMetricsConst(ConstantHolder):
    """Metric names; forward slash groups (reference :45)."""
    TRAIN_EPOCH = "train_base/epoch"
    TIME_TOTAL = "ztime/time_total"
    TIME_VAL = "ztime/time_val"
    VAL_LOSS = "val_base/loss"
    VAL_BEST_FIELD = "val_base/best_field"
    TRAIN_LR = "train_base/lr"
    PROFILE_GPU_MEM_USED = "zgpu/mem_used"
    TIME_STEP_FORWARD = "ztime/step_forward"
    TIME_STEP_BACKWARD = "ztime/step_backward"
    TIME_STEP_TOTAL = "ztime/step_total"
    TIME_STEP_OTHER = "ztime/step_other"
    TRAIN_GRAD_CLIP = "train_base/grad_clip_total_norm"
    TRAIN_LOSS = "train_base/loss"
    PROFILE_RAM_USED = "zram/used"
    # offline performance profiles and the experiment identity, read by
    # the results tables
    PERF_GFLOPS = "perf/gflops"
    PERF_PARAMS = "perf/params"
    PERF_SPEED = "perf/speed"
    EXP_GROUP = "exp_group"
    EXP_NAME = "exp_name"
    RUN_NAME = "run_name"


class TextMetricsConst(ConstantHolder):
    """Caption metric names (reference metric.py:99)."""
    BLEU_1 = "cap/b1"
    BLEU_2 = "cap/b2"
    BLEU_3 = "cap/b3"
    BLEU_4 = "cap/b4"
    METEOR = "cap/met"
    ROUGE_L = "cap/rol"
    CIDER = "cap/cid"
    RE1 = "cap/re1"
    RE2 = "cap/re2"
    RE3 = "cap/re3"
    RE4 = "cap/re4"
    SUBMISSION_VOCAB_SIZE = "cap/voc"
    SUBMISSION_AVG_SEN_LEN = "cap/slen"
    SUBMISSION_NUM_SEN = "cap/snum"
    GT_STAT_VOCAB_SIZE = "capgt/voc"
    GT_STAT_AVG_SEN_LEN = "capgt/slen"
    GT_STAT_NUM_SEN = "capgt/snum"


# mapping from evaluator result keys to metric names (reference :149)
TRANSLATION_METRICS: Dict[str, str] = {
    "Bleu_1": TextMetricsConst.BLEU_1,
    "Bleu_2": TextMetricsConst.BLEU_2,
    "Bleu_3": TextMetricsConst.BLEU_3,
    "Bleu_4": TextMetricsConst.BLEU_4,
    "METEOR": TextMetricsConst.METEOR,
    "ROUGE_L": TextMetricsConst.ROUGE_L,
    "CIDEr": TextMetricsConst.CIDER,
    "re1": TextMetricsConst.RE1,
    "re2": TextMetricsConst.RE2,
    "re3": TextMetricsConst.RE3,
    "re4": TextMetricsConst.RE4,
    "submission_vocab_size": TextMetricsConst.SUBMISSION_VOCAB_SIZE,
    "submission_avg_sen_len": TextMetricsConst.SUBMISSION_AVG_SEN_LEN,
    "submission_num_sen": TextMetricsConst.SUBMISSION_NUM_SEN,
    "gt_stat_vocab_size": TextMetricsConst.GT_STAT_VOCAB_SIZE,
    "gt_stat_avg_sen_len": TextMetricsConst.GT_STAT_AVG_SEN_LEN,
    "gt_stat_num_sen": TextMetricsConst.GT_STAT_NUM_SEN,
}


class AverageMeter:
    """Running value/avg meter (reference metric.py:406)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.value, self.sum, self.count, self.avg = 0.0, 0.0, 0, 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.value = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class MeterSettings:
    def __init__(self, per_step: bool, use_value: bool, use_avg: bool,
                 reset_avg_each_epoch: bool) -> None:
        self.per_step = per_step
        self.use_value = use_value
        self.use_avg = use_avg
        self.reset_avg_each_epoch = reset_avg_each_epoch


class MetricsWriter:
    """Metrics manager (reference metric.py:194). `exp` must provide
    get_metrics_step_file(epoch) and get_metrics_epoch_file(epoch)."""

    def __init__(self, exp) -> None:
        self.exp = exp
        self.meters: Dict[str, AverageMeter] = {}
        self.meter_settings: Dict[str, MeterSettings] = {}
        self.storage_step: Dict[str, List[Tuple[int, float]]] = \
            defaultdict(list)
        self.storage_epoch: Dict[str, List[Tuple[int, float]]] = \
            defaultdict(list)

    def add_meter(self, meter_name: str, *, per_step: bool = False,
                  use_value: bool = True, use_avg: bool = True,
                  reset_avg_each_epoch: bool = False) -> None:
        if meter_name in self.meters:
            raise ValueError(f"Meter {meter_name} already exists")
        self.meters[meter_name] = AverageMeter()
        self.meter_settings[meter_name] = MeterSettings(
            per_step, use_value, use_avg, reset_avg_each_epoch)

    def update_meter(self, meter_name: str, value: float) -> None:
        if meter_name not in self.meters:
            raise KeyError(f"Meter {meter_name} does not exist.")
        self.meters[meter_name].update(float(value))

    def hook_epoch_start(self) -> None:
        for meter_name, meter in self.meters.items():
            if self.meter_settings[meter_name].reset_avg_each_epoch:
                meter.reset()

    def feed_metrics(self, per_step: bool, total_step: int,
                     current_epoch: int) -> None:
        storage = self.storage_step if per_step else self.storage_epoch
        key = total_step if per_step else current_epoch
        for meter_name, meter in self.meters.items():
            settings = self.meter_settings[meter_name]
            if settings.per_step != per_step or meter.count == 0:
                continue
            if settings.use_value:
                storage[meter_name].append((key, meter.value))
            if settings.use_avg:
                storage[meter_name + "-avg"].append((key, meter.avg))

    def load_epoch(self, current_epoch: int) -> None:
        logger = logging.getLogger(LOGGER_NAME)
        for attr, file in (
                ("storage_step",
                 self.exp.get_metrics_step_file(current_epoch)),
                ("storage_epoch",
                 self.exp.get_metrics_epoch_file(current_epoch))):
            if not file.is_file():
                logger.warning(f"Metrics in {file} not found.")
                continue
            setattr(self, attr, defaultdict(list, json.loads(
                file.read_text())))

    def save_epoch_to_file(self, file) -> None:
        """The per-epoch storage alone, e.g. `val_ep_<ep>.json` of a
        validation run."""
        Path(file).write_text(json.dumps(self.storage_epoch))

    def save_epoch(self, current_epoch: int) -> None:
        self.exp.get_metrics_step_file(current_epoch).write_text(
            json.dumps(self.storage_step))
        self.exp.get_metrics_epoch_file(current_epoch).write_text(
            json.dumps(self.storage_epoch))
