"""
Show captioning results of experiment trees:

    python -m coot_videotext_tpu_torch.show_caption [--log_dir experiments] \\
        [-g GROUP_PATTERNS] [-s NAME_PATTERNS] [--mean | --mean_all] \\
        [--last] [-m all] [-f FIELDS] [--sort FIELD] [--compact]

BLEU-4, METEOR, ROUGE-L, CIDEr and the 4-gram repetition by default, read
from the metric files the port's caption trainer writes. Port of
show_caption.py at the repo root (reference show_caption.py) on
utils/view_results.py; show_mart.py reads the legacy "mart" experiment
type the same way. Pure Python: no device.
"""

from typing import List, Optional

from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.arguments import ArgParser
from coot_videotext_tpu_torch.utils.general import (
    ExperimentTypesConst, LOGGER_NAME, create_logger_without_file)
from coot_videotext_tpu_torch.utils.view_results import (
    TEXT_METRICS, collect_results_data, match_folder, output_results,
    update_performance_profile)

EXP_TYPE = ExperimentTypesConst.CAPTION
DEFAULT_FIELDS = ["bleu4", "meteo", "rougl", "cider", "re4"]


def show_text_results(exp_type: str, argv: Optional[List[str]],
                      description: str) -> None:
    """The caption metric table of the experiments of `exp_type`."""
    parser = ArgParser(description=description)
    arguments.add_multi_experiment_args(parser)
    arguments.add_show_args(parser)
    arguments.add_path_args(parser, dataset_path=False)
    arguments.add_default_args(parser)
    args = parser.parse_args(argv)
    create_logger_without_file(LOGGER_NAME, log_level=args.log_level)

    exp_groups_names = match_folder(args.log_dir, exp_type,
                                    args.exp_group, args.exp_list,
                                    args.search)
    collector = collect_results_data(
        exp_type, exp_groups_names, log_dir=args.log_dir,
        read_last_epoch=args.last, add_group=args.add_group)
    collector = update_performance_profile(collector)
    output_results(collector, custom_metrics=TEXT_METRICS,
                   metrics=args.metrics, default_metrics=[],
                   fields=args.fields, default_fields=DEFAULT_FIELDS,
                   mean=args.mean, mean_all=args.mean_all,
                   sort=args.sort, sort_asc=args.sort_asc,
                   compact=args.compact)


def main(argv: Optional[List[str]] = None) -> None:
    show_text_results(EXP_TYPE, argv, __doc__)


if __name__ == "__main__":
    main()
