"""
Retrieval validation and embedding export with the PyTorch package (the
flags of the repo's train_retrieval.py, :62-120).

    python -m coot_videotext_tpu_torch.train_retrieval \\
        -c config/retrieval/paper2020/yc2_2d3d_coot.yaml --validate \\
        [--load_model model_<ep>.pth] [--save_embeddings] \\
        [--ignore_untrained] [--device cpu] [--embeddings_format npz]

Runs on the CUDA device unless `--device cpu` is given; asked for CUDA
without a GPU it raises. `--load_model` takes a reference-layout
checkpoint ({net_name: state_dict}); without it, `--load_epoch N` or the
newest `models/model_<ep>.pth` of the experiment directory is loaded.
Training is the next slice of the port: without --validate this exits
with an error.
"""

from __future__ import annotations

import glob
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.tasks.retrieval.config import (
    ExperimentTypesConst, RetrievalConfig)
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.validate import (
    validate_retrieval)
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.general import (
    LOGGER_NAME, TrainerPathConst, create_logger)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file

EXP_TYPE = ExperimentTypesConst.RETRIEVAL


def resolve_device(name: str) -> torch.device:
    """`cuda` (the default) needs a GPU and raises without one; `cpu` is
    only taken when asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name}")
    return device


def _checkpoint_to_load(path_models: Path, load_model: Optional[str],
                        load_epoch: Optional[int]) -> Optional[Path]:
    """Explicit file > requested epoch > newest model_<ep>.pth."""
    if load_model:
        if load_epoch:
            raise ValueError("--load_model cannot be combined with "
                             "--load_epoch")
        return Path(load_model)
    prefix = TrainerPathConst.FILE_PREFIX_MODEL
    if load_epoch:
        return path_models / f"{prefix}_{load_epoch}.pth"
    found = sorted(glob.glob(str(path_models / f"{prefix}_*.pth")),
                   key=lambda f: int(Path(f).stem.split("_")[-1]))
    return Path(found[-1]) if found else None


def build_parser() -> arguments.ArgParser:
    parser = arguments.ArgParser(description=__doc__)
    arguments.add_default_args(parser)
    arguments.add_exp_identifier_args(parser)
    arguments.add_trainer_args(parser)
    parser.add_argument("--load_model", type=str, default=None,
                        help="Load model from a reference-layout .pth.")
    parser.add_argument("--save_embeddings", action="store_true",
                        help="Save generated COOT embeddings.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--embeddings_format", choices=("h5", "npz"),
                        default="h5",
                        help="h5 (the JAX trainer's file) or npz (same "
                             "arrays, for machines without h5py).")
    return parser


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Run the CLI; returns the validation results of each run."""
    args = build_parser().parse_args(argv)
    if not args.validate:
        sys.exit("Training is not ported yet: it is the next slice of the "
                 "PyTorch port (ROADMAP). Use --validate.")
    device = resolve_device(args.device)
    exp_group, exp_name, config_file = \
        arguments.setup_experiment_identifier_from_args(args, EXP_TYPE)
    config = load_yaml_config_file(config_file)
    path_data = arguments.update_path_from_args(args)
    config = arguments.update_config_from_args(config, args)
    cfg = RetrievalConfig(config, is_train=False)
    if args.print_config:
        print(cfg)
    seed = cfg.random_seed if cfg.random_seed is not None else 0
    _, _, _, val_loader = create_retrieval_datasets_and_loaders(
        cfg, path_data, seed=seed)

    all_results = []
    for run_number in range(args.start_run,
                            args.start_run + args.num_runs):
        run_name = f"{args.run_name}{run_number}"
        path_base = (Path(args.log_dir) / EXP_TYPE / exp_group /
                     f"{exp_name}_{run_name}")
        logger = create_logger(
            LOGGER_NAME, log_dir=path_base / TrainerPathConst.DIR_LOGS)
        mgr = RetrievalModelManager(cfg, device, seed=seed)
        logger.info(f"Model: {mgr.count_parameters():,} parameters on "
                    f"{device}, val dtype {mgr.val_dtype}")
        ckpt = _checkpoint_to_load(
            path_base / TrainerPathConst.DIR_MODELS, args.load_model,
            args.load_epoch)
        epoch = 0
        if ckpt is not None:
            logger.info(f"Loading model from {ckpt}")
            mgr.load_file(str(ckpt))
            if ckpt.stem.startswith(f"{TrainerPathConst.FILE_PREFIX_MODEL}_"):
                epoch = int(ckpt.stem.split("_")[-1])
        if not mgr.was_loaded and not args.ignore_untrained:
            raise ValueError(
                "Validating an untrained model! No checkpoints were "
                "loaded. Add --ignore_untrained to validate anyway.")
        emb_file = None
        if args.save_embeddings or cfg.val.save_embeddings:
            emb_file = (path_base / TrainerPathConst.DIR_EMBEDDINGS /
                        f"embeddings_{epoch}.{args.embeddings_format}")
        generator = torch.Generator(device=device).manual_seed(42)
        results = validate_retrieval(
            mgr.model, cfg, val_loader, device,
            compute_dtype=mgr.val_dtype, val_clips=cfg.val.val_clips,
            emb_file=emb_file, generator=generator, logger=logger)
        results["emb_file"] = emb_file
        all_results.append(results)
    return all_results


if __name__ == "__main__":
    main()
