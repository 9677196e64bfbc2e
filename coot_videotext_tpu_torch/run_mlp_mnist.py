"""
Run the MLP example experiment (examples/mlp_mnist.py):

    python -m coot_videotext_tpu_torch.run_mlp_mnist -g default -e mnist \\
        [-o train.num_epochs=N] [--reset] [--validate] [--load_epoch E] \\
        [--log_dir experiments] [--device cpu]

trains on synthetic MNIST-like digits (checkpoints in
experiments/mlp/<group>/<name>_<run>/, a rerun resumes) or validates a
checkpoint. Port of run_mlp_mnist.py at the repo root (reference
run_mlp_mnist.py). Runs on the CUDA device unless `--device cpu` is given;
asked for CUDA without a GPU it raises; under `torchrun
--nproc_per_node=W` it runs W data-parallel ranks (parallel/mesh.py).
Returns per run the trainer's state and its validation metrics by epoch.
"""

import dataclasses
from typing import Any, Dict, List, Optional

from coot_videotext_tpu_torch.examples.mlp_mnist import (
    EXP_TYPE, MLPMNISTDataLoader, MLPMNISTExperimentConfig,
    MLPMNISTTrainer, MLPModelManager, make_synthetic_mnist)
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.train_retrieval import resolve_device
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.arguments import ArgParser
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    parser = ArgParser(description=__doc__)
    arguments.add_default_args(parser)
    arguments.add_exp_identifier_args(parser)
    arguments.add_trainer_args(parser, dataset_path=False)
    parser.add_argument("--load_model", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    exp_group, exp_name, config_file = \
        arguments.setup_experiment_identifier_from_args(args, EXP_TYPE)
    config = load_yaml_config_file(config_file)
    config = arguments.update_config_from_args(config, args)
    cfg = MLPMNISTExperimentConfig(config)
    if args.print_config:
        print(cfg)
    mesh = pmesh.get_mesh(cfg.mesh_shape, device.type)
    try:
        return _run(args, cfg, exp_group, exp_name, mesh)
    finally:
        pmesh.destroy(mesh)


def _run(args, cfg: MLPMNISTExperimentConfig, exp_group: str,
         exp_name: str, mesh: pmesh.Mesh) -> List[Dict[str, Any]]:
    device = mesh.device
    seed = cfg.random_seed or 0
    (train_x, train_y), (val_x, val_y) = make_synthetic_mnist()
    train_loader = MLPMNISTDataLoader(train_x, train_y,
                                      cfg.train.batch_size, shuffle=True,
                                      seed=seed, mesh=mesh)
    val_loader = MLPMNISTDataLoader(val_x, val_y, cfg.val.batch_size,
                                    shuffle=False, mesh=mesh)

    results = []
    for run_number in range(args.start_run,
                            args.start_run + args.num_runs):
        run_name = f"{args.run_name}{run_number}"
        model_mgr = MLPModelManager(cfg, device, seed=seed)
        trainer = MLPMNISTTrainer(
            cfg, model_mgr, exp_group, exp_name, run_name,
            len(train_loader), log_dir=args.log_dir, reset=args.reset,
            load_best=args.load_best or (args.validate
                                         and args.load_epoch is None),
            load_epoch=args.load_epoch, load_model=args.load_model,
            is_test=args.validate, mesh=mesh)
        try:
            if args.validate:
                loss, acc, _ = trainer.validate_epoch(val_loader)
                results.append({"val_loss": loss, "val_accuracy": acc,
                                "device": device})
            else:
                trainer.train_model(train_loader, val_loader)
                epochs = trainer.metrics.storage_epoch
                results.append({
                    "path_base": trainer.exp.path_base,
                    "state": dataclasses.asdict(trainer.state),
                    "val_accuracy": [v for _, v in
                                     epochs["val_base/best_field"]],
                    "val_loss": [v for _, v in epochs["val_base/loss"]],
                    "device": device})
        finally:
            trainer.close()
    return results


if __name__ == "__main__":
    main()
