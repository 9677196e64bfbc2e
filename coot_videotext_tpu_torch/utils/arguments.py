"""
Composable argparse groups for the experiment scripts (copy of
coot_videotext_tpu/utils/arguments.py).

CLI-surface parity with reference nntrainer/arguments.py: identical flags
(-c/-g/-e/-r/-n/-a identity, -o dotted config overrides with type coercion,
--workers/--seed/--load_epoch/--load_best/--validate/--reset/--print_*,
--no_cuda/--single_gpu accepted for compatibility) so published command
lines run unchanged.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any, Dict, Tuple

from coot_videotext_tpu_torch.utils.general import TrainerPathConst

DEFAULT_DATA_PATH = "data"


class ArgParser(argparse.ArgumentParser):
    """Parser with defaults shown in help (reference utils.py:136)."""

    def __init__(self, description: str = "no description given", **kwargs):
        super().__init__(
            description=description,
            formatter_class=argparse.ArgumentDefaultsHelpFormatter, **kwargs)


def add_default_args(parser) -> None:
    """Logging level flags -v/-q (reference arguments.py:89)."""
    group = parser.add_mutually_exclusive_group()
    group.set_defaults(log_level=logging.INFO)
    group.add_argument("-v", "--verbose", help="Verbose (debug) logging",
                       action="store_const", const=logging.DEBUG,
                       dest="log_level")
    group.add_argument("-q", "--quiet", help="Only log warnings",
                       action="store_const", const=logging.WARN,
                       dest="log_level")
    group.add_argument("--log", help="Set log level manually", type=str,
                       dest="log_level")


def add_multi_experiment_args(parser) -> None:
    """Experiment search flags of the results tables."""
    parser.add_argument("-g", "--exp_group", type=str, default=None,
                        help="Search experiment group and name. Supports "
                             ".gitignore-like patterns, separated by comma.")
    parser.add_argument("-s", "--search", type=str, default=None,
                        help="Search experiments name only.")
    parser.add_argument("-l", "--exp_list", type=str, default=None,
                        help="Experiment list file.")


def add_show_args(parser) -> None:
    """Results-table flags (reference arguments.py:160)."""
    parser.add_argument("--last", action="store_true",
                        help="View last epoch results instead of best.")
    parser.add_argument("--mean", action="store_true",
                        help="Average over runs with same run name.")
    parser.add_argument("--add_group", action="store_true",
                        help="Add experiment group to identifier.")
    parser.add_argument("--mean_all", action="store_true",
                        help="Average over all runs of an experiment.")
    parser.add_argument("--sort_asc", action="store_true",
                        help="Sort ascending instead of descending.")
    parser.add_argument("--sort", type=str, default="score",
                        help="Sorting field, alpha for alphabetic.")
    parser.add_argument("--compact", action="store_true",
                        help="Compact the printed table.")
    parser.add_argument("-m", "--metrics", type=str, default="",
                        help="Which metric groups to print ('all' or csv).")
    parser.add_argument("--less_metrics", action="store_true",
                        help="Hide the basic metrics like loss, score.")
    parser.add_argument("-f", "--fields", type=str, default="",
                        help="Field or comma separated fields to print.")


def add_exp_group_arg(parser) -> None:
    parser.add_argument("-c", "--config_file", type=str, default=None,
                        help="Specify either config file location or "
                             "experiment group and name.")
    parser.add_argument("-g", "--exp_group", type=str, default="default",
                        help="Experiment group. Path to config: "
                             "config/$TYPE/$GROUP/$NAME.yaml")


def add_exp_identifier_args(parser) -> None:
    add_exp_group_arg(parser)
    parser.add_argument("-e", "--exp_name", type=str, default="default",
                        help="Experiment name.")
    _add_run_args(parser)


def _add_run_args(parser) -> None:
    parser.add_argument("-n", "--num_runs", type=int, default=1,
                        help="How many runs to do.")
    parser.add_argument("-a", "--start_run", type=int, default=1,
                        help="Start at which run number.")
    parser.add_argument("-r", "--run_name", type=str, default="run",
                        help="Run name to save the model. "
                             "Must not contain underscores.")


def _add_gpu_args(parser) -> None:
    # accepted for reference-CLI compatibility; --device selects the device
    parser.add_argument("--no_cuda", action="store_true",
                        help="(compat) no effect; use --device cpu.")
    parser.add_argument("--single_gpu", action="store_true",
                        help="One rank: mesh_shape {data: 1}; under "
                             "torchrun with more ranks it raises.")


def add_path_args(parser, *, dataset_path: bool = True,
                  profiling_path: bool = False) -> None:
    parser.add_argument("--config_dir", type=str,
                        default=TrainerPathConst.DIR_CONFIG,
                        help="Folder with config files.")
    parser.add_argument("--log_dir", type=str,
                        default=TrainerPathConst.DIR_EXPERIMENTS,
                        help="Folder with experiment results.")
    if dataset_path:
        add_dataset_path_arg(parser)
    if profiling_path:
        parser.add_argument("--profiling_dir", type=str,
                            default=TrainerPathConst.DIR_PROFILING,
                            help="Profiling output.")


def add_dataset_path_arg(parser) -> None:
    parser.add_argument("--data_path", type=str, default=None,
                        help="Change the data path.")


def add_trainer_args(parser, *, dataset_path: bool = True,
                     profiling_path: bool = False) -> None:
    parser.add_argument("-o", "--config", type=str, default=None,
                        help="Modify the loaded YAML config, e.g. "
                             "'-o train.batch_size=32,val.val_freq=2'")
    parser.add_argument("--print_config", action="store_true",
                        help="Print the experiment config.")
    parser.add_argument("--workers", type=int, default=None,
                        help="Shortcut for setting dataloader workers.")
    add_path_args(parser, dataset_path=dataset_path,
                  profiling_path=profiling_path)
    parser.add_argument("--load_epoch", type=int, default=None,
                        help="Load epoch number.")
    parser.add_argument("--load_best", action="store_true",
                        help="Load best epoch.")
    parser.add_argument("--validate", action="store_true",
                        help="Validation only.")
    parser.add_argument("--ignore_untrained", action="store_true",
                        help="Validate even if no checkpoint was loaded.")
    parser.add_argument("--reset", action="store_true",
                        help="Delete experiment.")
    parser.add_argument("--print_graph", action="store_true",
                        help="Print model and forward pass, then exit.")
    parser.add_argument("--seed", type=str, default=None,
                        help="Set seed. integer or none/null for "
                             "auto-generated seed.")
    _add_gpu_args(parser)


# ---------- utilities ----------

def update_config_from_args(config: Dict, args: argparse.Namespace, *,
                            verbose: bool = True) -> Dict[str, Any]:
    """Apply -o dotted overrides + flag shortcuts (reference :266)."""
    if args.config is not None:
        for field_value in args.config.split(","):
            fields_str, value = field_value.strip().split("=")
            try:
                value = float(value)
                if round(value) == value:
                    value = int(value)
            except ValueError:
                pass
            if str(value).lower() == "true":
                value = True
            elif str(value).lower() == "false":
                value = False
            fields = fields_str.split(".")
            current_dict = config
            for i, field in enumerate(fields):
                if i == len(fields) - 1:
                    if field not in current_dict:
                        assert "same_as" in current_dict, (
                            f"Field {fields_str} not found in config "
                            f"{list(current_dict.keys())}.")
                    current_dict[field] = value
                    if verbose:
                        print(f"    Change config: "
                              f"Set {fields_str} = {value}")
                    break
                current_dict = current_dict[field]

    if getattr(args, "workers", None) is not None:
        config["dataset_train"]["num_workers"] = int(args.workers)
        config["dataset_val"]["num_workers"] = int(args.workers)
        if verbose:
            print(f"    Change config: workers = {args.workers}")

    if getattr(args, "seed", None) is not None:
        if str(args.seed).lower() in ("none", "null"):
            config["random_seed"] = None
        else:
            config["random_seed"] = int(args.seed)
        if verbose:
            print(f"    Change config: Set seed to {args.seed}.")

    if getattr(args, "no_cuda", False):
        config["use_cuda"] = False
    if getattr(args, "single_gpu", False):
        config["use_multi_gpu"] = False
        config["mesh_shape"] = {"data": 1}
    return config


def update_path_from_args(args: argparse.Namespace) -> Path:
    path = (args.data_path if getattr(args, "data_path", None) is not None
            else DEFAULT_DATA_PATH)
    return Path(path)


def setup_config_file_from_experiment_identifier(
        exp_type: str, exp_group: str, exp_name: str, *,
        config_dir: str = TrainerPathConst.DIR_CONFIG) -> Path:
    return Path(config_dir) / exp_type / exp_group / f"{exp_name}.yaml"


def setup_experiment_identifier_from_args(args: argparse.Namespace,
                                          exp_type: str
                                          ) -> Tuple[str, str, str]:
    """Resolve (group, name, config file) (reference :354)."""
    if args.config_file is None:
        exp_group = args.exp_group
        exp_name = args.exp_name
        config_file = setup_config_file_from_experiment_identifier(
            exp_type, exp_group, exp_name, config_dir=args.config_dir)
    else:
        exp_group = args.exp_group
        exp_name = ".".join(
            str(Path(args.config_file).parts[-1]).split(".")[:-1])
        config_file = args.config_file
    print(f"Source config: {config_file}")
    print(f"Results path:  {args.log_dir}/{exp_type}/{exp_group}/"
          f"{exp_name}")
    return exp_group, exp_name, str(config_file)
