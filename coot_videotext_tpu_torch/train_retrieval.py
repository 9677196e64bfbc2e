"""
Retrieval training, validation and embedding export with the PyTorch
package (the flags of the repo's train_retrieval.py, :62-120).

    python -m coot_videotext_tpu_torch.train_retrieval \\
        -c config/retrieval/paper2020/yc2_2d3d_coot.yaml \\
        [-o train.num_epochs=N] [--reset] [--load_epoch E] [--device cpu] \\
        [--preload_device] [--fixed_shapes]

trains epochs, validates per `val_start` / `val_freq`, and writes the JAX
trainer's experiment tree under experiments/retrieval/<group>/<name>_<run>/
(trainerstate, per-step and per-epoch metrics json, scheduler json, and
`models/model_<ep>.pth` / `optimizer_<ep>.pth`); a run that finds
checkpoints resumes from the newest (or --load_epoch) unless --reset.

    python -m coot_videotext_tpu_torch.train_retrieval -c <yaml> --validate \\
        [--load_model model_<ep>.pth | --load_epoch E] [--save_embeddings] \\
        [--ignore_untrained] [--device cpu] [--embeddings_format npz]

validates one checkpoint: `--load_model` takes a reference-layout file
({net_name: state_dict}); without it, `--load_epoch E` or the newest
`models/model_<ep>.pth` of the experiment directory is loaded.
Runs on the CUDA device unless `--device cpu` is given; asked for CUDA
without a GPU it raises. The features live in a store in device memory when
`preload_device` says so ("auto": on a CUDA device when it fits;
`--preload_device` forces it, also on the CPU), and with `--fixed_shapes`
the device samples the frames and packs the parts too. On that path
`-o train.steps_per_dispatch=K` trains in groups of K steps, each group K
replays of a CUDA graph of the train step on the card (step by step on
the CPU).

    torchrun --standalone --nproc_per_node=W \
        -m coot_videotext_tpu_torch.train_retrieval -c <yaml> [...]

runs W data-parallel ranks (parallel/mesh.py): rank r on cuda:r over NCCL,
or on the CPU over gloo with `--device cpu`; the yaml's batch size is the
global batch, and only rank 0 writes. `mesh_shape` must match the ranks
(`--single_gpu` asks for one), and a `model` axis raises.
"""

from __future__ import annotations

import dataclasses
import glob
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.tasks.retrieval.config import (
    ExperimentTypesConst, RetrievalConfig)
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.trainer import (
    RetrievalTrainer)
from coot_videotext_tpu_torch.tasks.retrieval.validate import (
    validate_retrieval)
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.general import (
    LOGGER_NAME, TrainerPathConst, create_logger)
from coot_videotext_tpu_torch.utils.metrics import DefaultMetricsConst
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
        if load_epoch is not None:
            raise ValueError("--load_model cannot be combined with "
                             "--load_epoch")
        return Path(load_model)
    prefix = TrainerPathConst.FILE_PREFIX_MODEL
    if load_epoch is not None:
        return path_models / f"{prefix}_{load_epoch}.pth"
    found = sorted(glob.glob(str(path_models / f"{prefix}_*.pth")),
                   key=lambda f: int(Path(f).stem.split("_")[-1]))
    return Path(found[-1]) if found else None


def build_parser() -> arguments.ArgParser:
    parser = arguments.ArgParser(description=__doc__)
    arguments.add_default_args(parser)
    arguments.add_exp_identifier_args(parser)
    arguments.add_trainer_args(parser)
    parser.add_argument("--test_dataset", action="store_true",
                        help="Print one collated train batch and exit.")
    parser.add_argument("--preload", action="store_true",
                        help="Preload video and text features into RAM.")
    parser.add_argument("--preload_device", action="store_true",
                        help="Force the feature store in device memory "
                             "even where the auto budget declines it (or "
                             "on the CPU); batches then carry only row "
                             "indices, gathered on the device. Raises if "
                             "the store does not fit.")
    parser.add_argument("--fixed_shapes", action="store_true",
                        help="Pad batches to dataset-static shapes; with "
                             "the feature store this samples frames and "
                             "packs parts on the device, so batches carry "
                             "only datapoint ids.")
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
    """Run the CLI; returns one result dict per run: the validation
    results, or after training the experiment directory, the trainer
    state, the train loader's batch layout, the train steps dispatched one
    at a time and in groups (`dispatches`) and the per-step training
    losses."""
    args = build_parser().parse_args(argv)
    if args.save_embeddings and not args.validate:
        raise ValueError("--save_embeddings works in validation "
                         "(--validate) only")
    device = resolve_device(args.device)
    exp_group, exp_name, config_file = \
        arguments.setup_experiment_identifier_from_args(args, EXP_TYPE)
    config = load_yaml_config_file(config_file)
    path_data = arguments.update_path_from_args(args)
    config = arguments.update_config_from_args(config, args)
    if args.preload:
        for dset in ("dataset_train", "dataset_val"):
            config[dset]["preload_vid_feat"] = True
            config[dset]["preload_text_feat"] = True
    if args.preload_device:
        config["dataset_train"]["preload_device"] = True
    cfg = RetrievalConfig(config, is_train=not args.validate)
    if args.print_config:
        print(cfg)
    mesh = pmesh.get_mesh(cfg.mesh_shape, device.type)
    try:
        return _run(args, cfg, path_data, exp_group, exp_name, mesh)
    finally:
        pmesh.destroy(mesh)


def _run(args, cfg, path_data, exp_group: str, exp_name: str,
         mesh: pmesh.Mesh) -> List[Dict[str, Any]]:
    device = mesh.device
    seed = cfg.random_seed if cfg.random_seed is not None else 0
    train_set, _, train_loader, val_loader = \
        create_retrieval_datasets_and_loaders(
            cfg, path_data, seed=seed, device=device,
            fixed_shapes=True if args.fixed_shapes else None, mesh=mesh)
    if mesh.is_writer:
        _print_data_path(train_loader, val_loader)
    if args.test_dataset:
        _print_batch(len(train_set), train_loader)
        return []

    all_results = []
    for run_number in range(args.start_run,
                            args.start_run + args.num_runs):
        run_name = f"{args.run_name}{run_number}"
        mgr = RetrievalModelManager(cfg, device, seed=seed)
        if args.validate:
            all_results.append(_validate(args, cfg, mgr, val_loader,
                                         exp_group, exp_name, run_name,
                                         mesh))
            continue
        trainer = RetrievalTrainer(
            cfg, mgr, exp_group, exp_name, run_name, len(train_loader),
            log_dir=args.log_dir, reset=args.reset,
            load_best=args.load_best, load_epoch=args.load_epoch,
            load_model=args.load_model, mesh=mesh)
        try:
            trainer.train_model(train_loader, val_loader)
        except BaseException:
            trainer.logger.exception("Run aborted by uncaught exception:")
            raise
        losses = trainer.metrics.storage_step[DefaultMetricsConst.TRAIN_LOSS]
        all_results.append({
            "path_base": trainer.exp.path_base,
            "state": dataclasses.asdict(trainer.state),
            "layout": train_loader.layout,
            "dispatches": dict(trainer.dispatches),
            "step_losses": [v for _, v in losses],
            "rank": mesh.rank, "world": mesh.world})
    return all_results


def _print_data_path(train_loader, val_loader) -> None:
    stores = [ld.device_store for ld in (train_loader, val_loader)]
    if stores[0] is None:
        print(f"Data path: host ({train_loader.layout} batches)", flush=True)
        return
    meta = train_loader.device_meta
    if meta is None:
        sampling = "on the host"
    elif "pack_clips" in meta.shapes:
        sampling = "on the device, parts packed"
    else:
        sampling = "on the device"
    print(f"Feature store on {stores[0].device}: "
          f"{sum(s.nbytes for s in stores) / 1e9:.3f} GB (train "
          f"{stores[0].nbytes / 1e9:.3f}, val {stores[1].nbytes / 1e9:.3f}) "
          f"uploaded in {sum(s.upload_s for s in stores):.2f} s; frames "
          f"sampled {sampling}", flush=True)


def _print_batch(num_points: int, loader) -> None:
    """One collated batch's arrays (reference dataset_retrieval.py:491)."""
    print(f"Dataset: {num_points} datapoints, {len(loader)} batches.")
    for key, value in next(iter(loader)).items():
        if hasattr(value, "shape"):
            print(f"  {key}: {value.shape} {value.dtype}")
        elif isinstance(value, str):
            print(f"  {key}: {value}")
        else:
            print(f"  {key}: list[{len(value)}]")


def _validate(args, cfg, mgr: RetrievalModelManager, val_loader,
              exp_group: str, exp_name: str, run_name: str,
              mesh: pmesh.Mesh) -> Dict[str, Any]:
    path_base = (Path(args.log_dir) / EXP_TYPE / exp_group /
                 f"{exp_name}_{run_name}")
    logger = create_logger(
        LOGGER_NAME,
        log_dir=path_base / TrainerPathConst.DIR_LOGS if mesh.is_writer
        else "")
    logger.info(f"Model: {mgr.count_parameters():,} parameters on "
                f"{mgr.device}, val dtype {mgr.val_dtype}")
    ckpt = _checkpoint_to_load(path_base / TrainerPathConst.DIR_MODELS,
                               args.load_model, args.load_epoch)
    epoch = 0
    if ckpt is not None:
        logger.info(f"Loading model from {ckpt}")
        mgr.load_file(str(ckpt))
        if ckpt.stem.startswith(f"{TrainerPathConst.FILE_PREFIX_MODEL}_"):
            epoch = int(ckpt.stem.split("_")[-1])
    if not mgr.was_loaded and not args.ignore_untrained:
        raise ValueError(
            "Validating an untrained model! No checkpoints were loaded. "
            "Add --ignore_untrained to validate anyway.")
    pmesh.broadcast_params(mesh, mgr.model.parameters())
    emb_file = None
    if args.save_embeddings or cfg.val.save_embeddings:
        emb_file = (path_base / TrainerPathConst.DIR_EMBEDDINGS /
                    f"embeddings_{epoch}.{args.embeddings_format}")
    results = validate_retrieval(
        mgr.model, cfg, val_loader, mgr.device,
        compute_dtype=mgr.val_dtype, val_clips=cfg.val.val_clips,
        emb_file=emb_file if mesh.is_writer else None, cc_seed=42,
        logger=logger, mesh=mesh)
    results["emb_file"] = emb_file
    return results


if __name__ == "__main__":
    main()
