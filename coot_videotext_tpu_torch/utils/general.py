"""
General utilities (copy of coot_videotext_tpu/utils/general.py): logging,
timestamps, recursive `same_as` config references, strict leftover-key
config validation, and framework-wide path/name constants.

Behavioral parity with reference nntrainer/utils.py (resolve_sameas
:220, get_dict_value_recursively :259, check_config_dict :278, constants
:411-462); the implementation here is original.
"""

from __future__ import annotations

import copy
import datetime
import logging
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Union

from coot_videotext_tpu_torch import typext

LOGGER_NAME = "trainlog"
LOGGING_FORMATTER = logging.Formatter(
    "%(levelname)5s %(message)s", datefmt="%m%d %H%M%S")

# yaml config key whose content is ignored by the strict checker; used to park
# blocks that only exist as `same_as` sources (reference utils.py:290)
REF = "ref"
NONE = "none"


# ---------- Logging ----------


def create_logger(name: str = LOGGER_NAME, *, filename: str = "run",
                  log_dir: Union[str, Path] = "",
                  log_level: int = logging.INFO,
                  no_parent: bool = False, no_print: bool = False
                  ) -> logging.Logger:
    """
    Create a stdout + optional timestamped-file logger
    (reference utils.py:56 create_logger).
    """
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    remove_handlers(logger)
    if no_parent:
        logger.propagate = False
    if not no_print:
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(log_level)
        handler.setFormatter(LOGGING_FORMATTER)
        logger.addHandler(handler)
    if str(log_dir) != "":
        ts = get_timestamp_for_filename()
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        file_handler = logging.FileHandler(
            str(Path(log_dir) / f"{filename}_{ts}.log"))
        file_handler.setLevel(log_level)
        file_handler.setFormatter(LOGGING_FORMATTER)
        logger.addHandler(file_handler)
    return logger


def create_logger_without_file(name: str = LOGGER_NAME,
                               log_level: int = logging.INFO
                               ) -> logging.Logger:
    return create_logger(name, log_dir="", log_level=log_level)


def remove_handlers(logger: logging.Logger) -> None:
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def get_timestamp_for_filename() -> str:
    """Timestamp usable in filenames (reference utils.py)."""
    return datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")


# ---------- Config / dict ----------

def resolve_sameas_config_recursively(config: Dict, *,
                                      root_config: Optional[Dict] = None
                                      ) -> None:
    """
    Recursively resolve `same_as` references: a dict container with key
    ``same_as: "a.b.c"`` is filled with deep copies of all keys of the
    referenced container that it does not itself define
    (reference utils.py:220). Mutates `config` in place.
    """
    if root_config is None:
        root_config = config
    for key in list(config.keys()):
        value = config[key]
        if not isinstance(value, dict):
            continue
        same_as = value.get("same_as")
        if same_as is not None:
            source = get_dict_value_recursively(root_config, same_as)
            for src_key, src_val in source.items():
                if src_key not in value:
                    value[src_key] = copy.deepcopy(src_val)
            del value["same_as"]
        resolve_sameas_config_recursively(value, root_config=root_config)


def get_dict_value_recursively(dct: Dict, key: str) -> Any:
    """Nest into a dict with a dotted key path (reference utils.py:259)."""
    parts = key.split(".")
    node: Any = dct
    for part in parts:
        node = node[part]
    return node


def check_config_dict(name: str, config: Dict[str, Any],
                      strict: bool = True) -> None:
    """
    After pop-parsing a config dict, verify no unknown keys remain; `ref`
    blocks and all-None leftovers are tolerated (reference utils.py:278).
    """
    remaining = {k: v for k, v in config.items() if k != REF}
    if remaining and not all(v is None for v in remaining.values()):
        msg = (f"keys and values remaining in config {name}: "
               f"{list(remaining.keys())}, {list(remaining.values())}. "
               f"Possible sources: typo in the yaml field name; incorrect -o "
               f"override; field missing from the config class; `same_as` "
               f"leftovers that should be nulled.")
        if strict:
            raise ValueError(msg)
        logging.getLogger(LOGGER_NAME).warning(msg)


# ---------- Constants ----------

class ConfigNamesConst(typext.ConstantHolder):
    """Configuration group names (reference utils.py:411)."""
    TRAIN = "train"
    VAL = "val"
    DATASET_TRAIN = "dataset_train"
    DATASET_VAL = "dataset_val"
    LOGGING = "logging"
    SAVING = "saving"
    OPTIMIZER = "optimizer"
    LR_SCHEDULER = "lr_scheduler"


class TrainerPathConst(typext.ConstantHolder):
    """Directory and file names for training (reference utils.py:425)."""
    DIR_CONFIG = "config"
    DIR_EXPERIMENTS = "experiments"
    DIR_LOGS = "logs"
    DIR_MODELS = "models"
    DIR_METRICS = "metrics"
    DIR_EMBEDDINGS = "embeddings"
    DIR_TB = "tb"
    DIR_PROFILING = "profiling"
    DIR_CAPTION = "caption"
    DIR_ANNOTATIONS = "annotations"
    FILE_PREFIX_TRAINERSTATE = "trainerstate"
    FILE_PREFIX_MODEL = "model"
    FILE_PREFIX_MODELEMA = "modelema"
    FILE_PREFIX_OPTIMIZER = "optimizer"
    FILE_PREFIX_DATA = "data"
    FILE_PREFIX_METRICS_STEP = "metrics_step"
    FILE_PREFIX_METRICS_EPOCH = "metrics_epoch"
    FILE_PREFIX_TRANSL_RAW = "translations"
    FILE_PREFIX_TRANSL_LANG = "results_lang"
    FILE_PREFIX_TRANSL_STAT = "results_stat"
    FILE_PREFIX_TRANSL_REP = "results_rep"
    FILE_PREFIX_TRANSL_METRICS = "text_metrics"


class MetricComparisonConst(typext.ConstantHolder):
    """Best-epoch comparison modes (reference utils.py:454)."""
    VAL_DET_BEST_MODE_MIN = "min"
    VAL_DET_BEST_MODE_MAX = "max"
    VAL_DET_BEST_TH_MODE_REL = "rel"
    VAL_DET_BEST_TH_MODE_ABS = "abs"


class ExperimentTypesConst(typext.ConstantHolder):
    """Experiment types (task families)."""
    RETRIEVAL = "retrieval"
    CAPTION = "caption"
    MLP = "mlp"


