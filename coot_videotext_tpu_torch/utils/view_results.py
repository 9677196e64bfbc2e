"""
Offline results viewer: walk experiment dirs, read best/last epoch metric
jsons, average runs (mean ± std), print ASCII tables.

Copy of coot_videotext_tpu/utils/view_results.py (behavioral port of
reference nntrainer/view_results.py:23-496 (collect_results_data,
average_results_data, output_results, display_table /
display_table_compact) and nntrainer/utils.py:310-393
(match_folder; the gitignore-style matching uses fnmatch — `*` wildcards
behave as pathspec's for the patterns the tools use)). It reads the
metric and trainerstate files of either package's experiment trees: their
names and schema are the reference's in both.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from coot_videotext_tpu_torch.utils.experiments import ExperimentFilesHandler
from coot_videotext_tpu_torch.utils.general import (
    LOGGER_NAME, TrainerPathConst)
from coot_videotext_tpu_torch.utils.metrics import (
    DefaultMetricsConst, PrintGroupConst, TextMetricsConst)

RESULTS_TYPE = Dict[str, Dict[str, float]]
RE_SPLIT_RUN = re.compile(r"(.*?)([0-9]+)")


class PrintMetric(NamedTuple):
    """Table-column description (reference metric.py:34)."""
    long_name: str
    formatting: str
    decimals: int
    print_group: str
    format_lambda: Optional[Callable[[float], float]] = None


DEFAULT_METRICS: Dict[str, PrintMetric] = {
    "ep": PrintMetric(DefaultMetricsConst.TRAIN_EPOCH, "f", 0,
                      PrintGroupConst.BASE, None),
    "loss": PrintMetric(DefaultMetricsConst.VAL_LOSS, "f", 3,
                        PrintGroupConst.BASE, None),
    "score": PrintMetric(DefaultMetricsConst.VAL_BEST_FIELD, "f", 3,
                         PrintGroupConst.BASE, None),
    "GPU mem": PrintMetric(DefaultMetricsConst.PROFILE_GPU_MEM_USED, "f",
                           0, PrintGroupConst.PROFILE, None),
    "RAM": PrintMetric(DefaultMetricsConst.PROFILE_RAM_USED, "f", 1,
                       PrintGroupConst.PROFILE, None),
    "Time": PrintMetric(DefaultMetricsConst.TIME_TOTAL, "f", 2,
                        PrintGroupConst.PROFILE, lambda x: x / 3600),
    "GFlop": PrintMetric(DefaultMetricsConst.PERF_GFLOPS, "f", 3,
                         PrintGroupConst.PERFORMANCE, None),
    "MPar": PrintMetric(DefaultMetricsConst.PERF_PARAMS, "f", 2,
                        PrintGroupConst.PERFORMANCE, lambda x: x / 1e6),
    "InfMS": PrintMetric(DefaultMetricsConst.PERF_SPEED, "f", 2,
                         PrintGroupConst.PERFORMANCE, None),
}

TEXT_PRINT_GROUP = "text"
_T = TEXT_PRINT_GROUP
TEXT_METRICS: Dict[str, PrintMetric] = {
    "bleu1": PrintMetric(TextMetricsConst.BLEU_1, "%", 2, _T, None),
    "bleu2": PrintMetric(TextMetricsConst.BLEU_2, "%", 2, _T, None),
    "bleu3": PrintMetric(TextMetricsConst.BLEU_3, "%", 2, _T, None),
    "bleu4": PrintMetric(TextMetricsConst.BLEU_4, "%", 2, _T, None),
    "meteo": PrintMetric(TextMetricsConst.METEOR, "%", 2, _T, None),
    "rougl": PrintMetric(TextMetricsConst.ROUGE_L, "%", 2, _T, None),
    "cider": PrintMetric(TextMetricsConst.CIDER, "%", 2, _T, None),
    "re1": PrintMetric(TextMetricsConst.RE1, "%", 2, _T, None),
    "re2": PrintMetric(TextMetricsConst.RE2, "%", 2, _T, None),
    "re3": PrintMetric(TextMetricsConst.RE3, "%", 2, _T, None),
    "re4": PrintMetric(TextMetricsConst.RE4, "%", 2, _T, None),
    "c/voc": PrintMetric(TextMetricsConst.SUBMISSION_VOCAB_SIZE, "f", 0,
                         _T, None),
    "c/slen": PrintMetric(TextMetricsConst.SUBMISSION_AVG_SEN_LEN, "f",
                          2, _T, None),
    "c/snum": PrintMetric(TextMetricsConst.SUBMISSION_NUM_SEN, "f", 0,
                          _T, None),
    "t/voc": PrintMetric(TextMetricsConst.GT_STAT_VOCAB_SIZE, "f", 0,
                         _T, None),
    "t/slen": PrintMetric(TextMetricsConst.GT_STAT_AVG_SEN_LEN, "f", 2,
                          _T, None),
    "t/snum": PrintMetric(TextMetricsConst.GT_STAT_NUM_SEN, "f", 0,
                          _T, None),
}


def update_performance_profile(
        collector: RESULTS_TYPE,
        profiling_dir=TrainerPathConst.DIR_PROFILING) -> RESULTS_TYPE:
    """Merge offline performance profiles (GFLOPs/params/ms) stored in
    profiles/ into the collector (reference :128)."""
    for _exp_ident, metrics in collector.items():
        exp_group = metrics.get(DefaultMetricsConst.EXP_GROUP)
        exp_name = metrics.get(DefaultMetricsConst.EXP_NAME)
        if exp_group is None or exp_name is None:
            continue
        profile_file = (Path(profiling_dir)
                        / f"{exp_group}_{exp_name}.json")
        if not profile_file.is_file():
            continue
        prof = json.loads(profile_file.read_text(encoding="utf8"))
        for key in (DefaultMetricsConst.PERF_GFLOPS,
                    DefaultMetricsConst.PERF_PARAMS,
                    DefaultMetricsConst.PERF_SPEED):
            if key in prof:
                metrics[key] = prof[key]
    return collector


# ---------- experiment matching ----------

def match_folder(folder, exp_type: str, exp_group: Optional[str] = None,
                 exp_list=None, search: Optional[str] = None
                 ) -> Dict[str, List[str]]:
    """Find experiments matching gitignore-like patterns
    (reference utils.py:327)."""
    logger = logging.getLogger(LOGGER_NAME)
    assert not (exp_list is not None and exp_group is not None), (
        "Cannot provide --exp_list and --exp_group at the same time.")
    patterns: List[str] = []
    if exp_list is not None:
        for line in Path(exp_list).read_text(
                encoding="utf8").splitlines():
            line = line.strip()
            if line:
                patterns.append(line)
    elif exp_group is not None:
        patterns += [g.strip() for g in exp_group.split(",")]
    else:
        patterns.append("*")
    search_names = (["*"] if search is None
                    else [n.strip() for n in search.split(",")])

    def match_any(value: str, pats: List[str]) -> bool:
        return any(fnmatch.fnmatch(value, p) or fnmatch.fnmatch(
            value, f"{p}/*") or fnmatch.fnmatch(value, f"*/{p}")
            for p in pats)

    root_path = Path(folder) / exp_type
    logger.info(f"Matching in {root_path} for --exp_group {patterns}, "
                f"names --search {search_names}")
    found = defaultdict(list)
    if not root_path.is_dir():
        return found
    for new_exp_group in sorted(os.listdir(root_path)):
        group_dir = root_path / new_exp_group
        if not group_dir.is_dir():
            continue
        for new_exp_name in sorted(os.listdir(group_dir)):
            if new_exp_name.endswith(".yaml"):
                new_exp_name = new_exp_name[:-5]
            match_str = f"{new_exp_group}/{new_exp_name}"
            if match_any(match_str, patterns) and any(
                    fnmatch.fnmatch(new_exp_name, p)
                    for p in search_names):
                found[new_exp_group].append(new_exp_name)
    return found


# ---------- collection ----------

def collect_results_data(
        exp_type: str, exp_groups_names: Dict[str, List[str]], *,
        log_dir: str = TrainerPathConst.DIR_EXPERIMENTS,
        read_last_epoch: bool = False,
        add_group: bool = False) -> RESULTS_TYPE:
    """Read best/last epoch metrics per experiment (reference :23)."""
    logger = logging.getLogger(LOGGER_NAME)
    collector: RESULTS_TYPE = defaultdict(dict)
    not_found = []
    for exp_group, exp_names in exp_groups_names.items():
        root_path = Path(log_dir) / exp_type / exp_group
        if not root_path.is_dir():
            raise FileNotFoundError(f"Path {root_path} not known.")
        for exp_ident in exp_names:
            splits = exp_ident.split("_")
            exp_name, run_name = "_".join(splits[:-1]), splits[-1]
            ident = (f"{exp_group}/{exp_ident}" if add_group
                     else exp_ident)
            handler = ExperimentFilesHandler(exp_type, exp_group,
                                             exp_name, run_name,
                                             log_dir=log_dir)
            last_epoch = handler.find_last_epoch()
            best_epoch = handler.find_best_epoch()
            search_epoch = last_epoch if read_last_epoch else best_epoch
            if search_epoch == -1:
                metrics_epochs = handler.get_existing_metrics()
                if not metrics_epochs:
                    not_found.append(ident)
                    continue
                search_epoch = metrics_epochs[-1]
            epoch_file = handler.get_metrics_epoch_file(search_epoch)
            epoch_data = json.loads(
                epoch_file.read_text(encoding="utf8"))
            collector[ident][DefaultMetricsConst.EXP_GROUP] = exp_group
            collector[ident][DefaultMetricsConst.EXP_NAME] = exp_name
            collector[ident][DefaultMetricsConst.RUN_NAME] = run_name
            for key, metrics in epoch_data.items():
                values = [value for ep, value in metrics
                          if ep == search_epoch]
                assert len(values) == 1, (
                    f"File {epoch_file} metric {key}: {len(values)} "
                    f"results for epoch {search_epoch}")
                collector[ident][key] = values[0]
            step_file = handler.get_metrics_step_file(search_epoch)
            if not step_file.is_file():
                continue
            step_data = json.loads(step_file.read_text(encoding="utf8"))
            for key in (DefaultMetricsConst.TIME_STEP_FORWARD,
                        DefaultMetricsConst.TIME_STEP_BACKWARD,
                        DefaultMetricsConst.TIME_STEP_OTHER,
                        DefaultMetricsConst.TIME_STEP_TOTAL):
                if f"{key}-avg" in step_data:
                    collector[ident][key] = float(np.mean(
                        [v for _, v in step_data[f"{key}-avg"]]))
            for key in (DefaultMetricsConst.PROFILE_GPU_MEM_USED,
                        DefaultMetricsConst.PROFILE_RAM_USED):
                if key in step_data and step_data[key]:
                    collector[ident][key] = float(np.max(
                        [v for _, v in step_data[key]]))
    if not_found:
        logger.info(f"No results found for {not_found}")
    return collector


def average_results_data(collector: RESULTS_TYPE,
                         group_by_names: bool = False
                         ) -> Tuple[RESULTS_TYPE, RESULTS_TYPE,
                                    Dict[str, int]]:
    """Mean +- std over runs (reference :152)."""
    multi: Dict[str, Dict[str, List]] = defaultdict(
        lambda: defaultdict(list))
    for exp_ident, metrics in collector.items():
        splits = exp_ident.split("_")
        exp_name, run_name_full = "_".join(splits[:-1]), splits[-1]
        name = exp_name
        if group_by_names:
            found = RE_SPLIT_RUN.findall(run_name_full)
            run_name = found[0][0] if found else run_name_full
            name = f"{exp_name}_{run_name}"
        for metric_name, metric_value in metrics.items():
            multi[name][metric_name].append(metric_value)
    mean_c: RESULTS_TYPE = defaultdict(dict)
    std_c: RESULTS_TYPE = defaultdict(dict)
    num_models: Dict[str, int] = {}
    for exp_name, metrics in multi.items():
        for metric_name, vals in metrics.items():
            if len(vals) == 1 or isinstance(vals[0], str):
                mean, std = vals[0], 0
            else:
                arr = np.asarray(vals, np.float64)
                mean = float(np.mean(arr))
                std = float(np.sqrt(np.sum((arr - mean) ** 2)
                                    / (len(arr) - 1)))
            mean_c[exp_name][metric_name] = mean
            std_c[exp_name][metric_name] = std
            num_models[exp_name] = len(vals)
    return mean_c, std_c, num_models


# ---------- output ----------

def output_results(collector: RESULTS_TYPE,
                   custom_metrics: Optional[Dict[str, PrintMetric]] = None,
                   metrics: str = "", default_metrics=None,
                   fields: str = "", default_fields=None,
                   mean: bool = False, mean_all: bool = False,
                   sort: str = "score", sort_asc: bool = False,
                   compact: bool = False,
                   print_fn: Callable = print) -> None:
    """Render the results table (reference :219)."""
    logger = logging.getLogger(LOGGER_NAME)
    custom_metrics = custom_metrics or {}
    all_metrics = {**DEFAULT_METRICS, **custom_metrics}

    groups_available = sorted({m.print_group
                               for m in all_metrics.values()})
    groups_to_print = list(default_metrics or [])
    if metrics == "all":
        groups_to_print = groups_available
    elif metrics:
        groups_to_print += [g.strip() for g in metrics.split(",")]
    fields_to_print = list(default_fields or [])
    if fields:
        fields_to_print += [f.strip() for f in fields.split(",")]

    assert not (mean and mean_all)
    if mean_all:
        mean_c, std_c, num_models = average_results_data(collector)
    elif mean:
        mean_c, std_c, num_models = average_results_data(
            collector, group_by_names=True)
    else:
        mean_c, std_c, num_models = collector, None, None

    if sort == "alpha":
        sorted_names = sorted(mean_c.keys())
    else:
        sort_key = all_metrics[sort].long_name
        sort_values = [m.get(sort_key, 0) for m in mean_c.values()]
        sorted_names = list(np.array(list(mean_c.keys()))[
            np.argsort(sort_values)])
    if not sort_asc:
        sorted_names = list(reversed(sorted_names))

    print_keys = fields_to_print + [
        k for k, m in all_metrics.items()
        if m.print_group in groups_to_print]
    print_keys = [k for k in print_keys if any(
        all_metrics[k].long_name in m for m in mean_c.values())]
    logger.info(f"Metric groups available: {groups_available}; "
                f"printing {print_keys}")

    header = [("experiment (num)" if num_models is not None
               else "experiment")] + print_keys
    body: List[List[str]] = []
    for model in sorted_names:
        name_str = (f"{model} ({num_models[model]})"
                    if num_models is not None else str(model))
        line = [name_str]
        for key in print_keys:
            metr = all_metrics[key]
            fmt = "{:." + str(metr.decimals) + metr.formatting + "}"
            value = mean_c[model].get(metr.long_name, 0)
            if metr.format_lambda is not None:
                value = metr.format_lambda(value)
            out = fmt.format(value)
            if std_c is not None:
                std = std_c[model].get(metr.long_name, 0)
                if metr.format_lambda is not None:
                    std = metr.format_lambda(std)
                if std != 0:
                    out = f"{out} ±{fmt.format(std)}"
            line.append(out)
        body.append(line)

    print_fn()
    display_table(body, header, compact=compact, print_fn=print_fn)


def display_table(lines: List[List[str]],
                  header: Optional[List[str]] = None, *,
                  compact: bool = False,
                  print_fn: Callable = print) -> None:
    """Aligned ASCII table (reference :403/:484)."""
    rows = ([header] if header else []) + lines
    if not rows:
        return
    n_cols = max(len(r) for r in rows)
    widths = [max(len(str(r[c])) if c < len(r) else 0 for r in rows)
              for c in range(n_cols)]
    sep = " " if compact else " | "
    for i, row in enumerate(rows):
        cells = [str(row[c]).ljust(widths[c]) if c < len(row)
                 else " " * widths[c] for c in range(n_cols)]
        print_fn(sep.join(cells).rstrip())
        if header and i == 0 and not compact:
            print_fn("-+-".join("-" * w for w in widths))
