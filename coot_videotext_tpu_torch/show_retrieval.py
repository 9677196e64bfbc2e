"""
Show retrieval results of experiment trees:

    python -m coot_videotext_tpu_torch.show_retrieval \\
        [--log_dir experiments] [-g GROUP_PATTERNS] [-s NAME_PATTERNS] \\
        [--mean | --mean_all] [--last] [-m all] [-f FIELDS] \\
        [--sort FIELD] [--compact]

the modality x metric grid plus the vp-r1 / cs-r1 pair averages, read from
the metric files the port's retrieval trainer writes (the reference's
names and schema, so the JAX trainer's and the reference's trees read the
same). Port of show_retrieval.py at the repo root (reference
show_retrieval.py) on utils/view_results.py. Pure Python: no device.
"""

from typing import List, Optional

from coot_videotext_tpu_torch.tasks.retrieval.config import (
    CootMetersConst, ExperimentTypesConst)
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.arguments import ArgParser
from coot_videotext_tpu_torch.utils.general import (
    LOGGER_NAME, create_logger_without_file)
from coot_videotext_tpu_torch.utils.view_results import (
    PrintMetric, collect_results_data, match_folder, output_results,
    update_performance_profile)

EXP_TYPE = ExperimentTypesConst.RETRIEVAL
DEFAULT_FIELDS = ["v2p-r1", "p2v-r1", "c2s-r1", "s2c-r1", "Time"]


def grid_metric(modality: str, metric: str) -> PrintMetric:
    """One cell of the modality x metric grid. R@1 lives in the overview
    meter class (val_base), everything else in the detail class
    (val_ret); recall@N prints as a percentage, ranks as floats."""
    meter_class = "val_base" if metric == "r1" else "val_ret"
    fmt = "%" if metric.startswith("r") and metric[1:].isdigit() else "f"
    group = "vid" if "vid" in modality else "clip"
    return PrintMetric(f"{meter_class}/{modality}-{metric}", fmt, 2, group)


def add_r1_pair_averages(collector) -> None:
    """vp-r1 = mean of v2p/p2v R@1; cs-r1 likewise when clips were
    evaluated (the single-number scores the paper tables sort by)."""
    for model_name, metrics in collector.items():
        try:
            metrics["vp-r1"] = (metrics["val_base/vid2par-r1"]
                                + metrics["val_base/par2vid-r1"]) / 2
            if "val_base/cli2sen-r1" in metrics:
                metrics["cs-r1"] = (metrics["val_base/cli2sen-r1"]
                                    + metrics["val_base/sen2cli-r1"]) / 2
        except KeyError as e:
            print(f"WARNING: {e} for {model_name}")


def main(argv: Optional[List[str]] = None) -> None:
    parser = ArgParser(description=__doc__)
    arguments.add_multi_experiment_args(parser)
    arguments.add_show_args(parser)
    arguments.add_path_args(parser, dataset_path=False)
    arguments.add_default_args(parser)
    args = parser.parse_args(argv)
    create_logger_without_file(LOGGER_NAME, log_level=args.log_level)

    exp_groups_names = match_folder(args.log_dir, EXP_TYPE,
                                    args.exp_group, args.exp_list,
                                    args.search)
    collector = collect_results_data(
        EXP_TYPE, exp_groups_names, log_dir=args.log_dir,
        read_last_epoch=args.last, add_group=args.add_group)
    collector = update_performance_profile(collector)
    add_r1_pair_averages(collector)

    table = {
        f"{short}-{metric}": grid_metric(modality, metric)
        for modality, short in zip(CootMetersConst.RET_MODALITIES,
                                   CootMetersConst.RET_MODALITIES_SHORT)
        for metric in CootMetersConst.RET_METRICS}
    table["vp-r1"] = PrintMetric("vp-r1", "%", 2, "retrieval")
    table["cs-r1"] = PrintMetric("cs-r1", "%", 2, "retrieval")

    output_results(collector, custom_metrics=table,
                   metrics=args.metrics, default_metrics=[],
                   fields=args.fields, default_fields=DEFAULT_FIELDS,
                   mean=args.mean, mean_all=args.mean_all,
                   sort=args.sort, sort_asc=args.sort_asc,
                   compact=args.compact)


if __name__ == "__main__":
    main()
