"""
Caption training and validation with the PyTorch package: every caption
model of the JAX package (the recurrent MART model on COOT embeddings or
raw rgb+flow video features, the TransformerXL, the untied and the joint
single-sentence models, the MTransformer), BertAdam with the EMA shadow,
greedy or beam decoding and the caption metrics (the flags of the repo's
train_caption.py).

    python -m coot_videotext_tpu_torch.train_caption -c <yaml> \\
        [-o train.num_epochs=N] [--reset] [--load_epoch E] [--device cpu] \\
        [--annotations_dir D] [--coot_feat_dir D] [--cache_dir D] \\
        [--video_feature_dir D] [--dataset_max N]

trains over the train split (rerunning resumes from the newest
checkpoint, or from `--load_epoch`; `--load_model X.pth` warm-starts) and
validates per val_start / val_freq, writing under
experiments/caption/<group>/<name>_<run>/ the checkpoints
(`models/model_<ep>.pth`, `modelema_<ep>.pth`, `optimizer_<ep>.pth`,
trainerstate and metrics) and the translations. With `--validate
[--load_model X.pth | --load_epoch E] [--ignore_untrained]` it validates
one checkpoint over the val split instead: the teacher-forced loss and
token accuracy, the greedy paragraph translations (written to
caption/translations_<ep>_val.json) and BLEU 1-4, METEOR, ROUGE-L, CIDEr
with the sentence statistics and the repetition metrics
(`val_ep_<ep>.json`); an epoch of a run trained with an EMA is evaluated
with its EMA weights, a `--load_model` file (the reference layout
`{"model": state_dict}`) as it is. Without a checkpoint `--validate`
refuses unless `--ignore_untrained` is given. The COOT embeddings are read
from `--coot_feat_dir` as `<coot_model_name>_<split>.h5` or `.npz`; with
`coot_model_name: null` (config/caption/paper2020/yc2_mart.yaml,
anet_mart.yaml) the raw features from `--video_feature_dir` as
`<dset>/<video>_{resnet,bn}.npy`, indexed by the annotations'
captioning_video_feat_duration.csv. The variants are `-o` overrides of a
caption yaml:
    use_beam=true [beam_reference_compat=true]   beam search (beam_size,
        n_best, min_sen_len, max_sen_len, block_ngram_repeat and the length
        penalty from the yaml) on the recurrent MART model
    xl=true [xl_grad=true]                       the TransformerXL
    recurrent=false,untied=true                  the untied model
    recurrent=false                              the joint single-sentence
                                                 NonRecurTransformer
    recurrent=false,mtrans=true                  the MTransformer
                                                 (yc2_100m_coot_vidclip_mtrans)
    share_wd_cls_weight=true,word_vec_size=<hidden_size>,use_glove=false
                                                 the decoder tied to the word
                                                 embeddings
The single-sentence models train on sentences (`train_unit`). Beam search
on any other model than the recurrent MART one is refused, as the JAX
package refuses it. Runs on the CUDA device unless `--device cpu` is
given; asked for CUDA without a GPU it raises. Under `torchrun
--nproc_per_node=W` it runs W data-parallel ranks (parallel/mesh.py; NCCL
on the card, gloo with `--device cpu`): the yaml's batch size is the
global batch, rank 0 decodes and writes.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from coot_videotext_tpu_torch.data.caption_dataset import (
    create_mart_datasets_and_loaders)
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.tasks.caption.config import (
    MartConfig, MartPathConst)
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    build_mart_model_manager)
from coot_videotext_tpu_torch.tasks.caption.trainer import MartTrainer
from coot_videotext_tpu_torch.train_retrieval import resolve_device
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.general import ExperimentTypesConst
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file

EXP_TYPE = ExperimentTypesConst.CAPTION


def add_mart_args(parser) -> None:
    """MART path/preload flags (reference mart/arguments_mart.py)."""
    parser.add_argument("--cache_dir", type=str,
                        default=MartPathConst.CACHE_DIR,
                        help="Cached vocabulary dir.")
    parser.add_argument("--coot_feat_dir", type=str,
                        default=MartPathConst.COOT_FEAT_DIR,
                        help="COOT embeddings dir.")
    parser.add_argument("--annotations_dir", type=str,
                        default=MartPathConst.ANNOTATIONS_DIR,
                        help="Annotations dir.")
    parser.add_argument("--video_feature_dir", type=str,
                        default=MartPathConst.VIDEO_FEATURE_DIR,
                        help="Dir containing the video features.")
    parser.add_argument("--dataset_max", type=int, default=None,
                        help="Reduce dataset size for testing.")
    parser.add_argument("--preload", action="store_true",
                        help="Preload video features.")
    parser.add_argument("--no_preload", action="store_true",
                        help="Do not preload video features.")


def update_mart_config_from_args(config: Dict[str, Any], args
                                 ) -> Dict[str, Any]:
    """(reference mart/arguments_mart.py:28)."""
    if args.dataset_max is not None:
        assert args.dataset_max > 0
        config["dataset_train"]["max_datapoints"] = args.dataset_max
        config["dataset_val"]["max_datapoints"] = args.dataset_max
    if args.preload:
        config["dataset_train"]["preload"] = True
        config["dataset_val"]["preload"] = True
    if args.no_preload or args.validate:
        config["dataset_train"]["preload"] = False
        config["dataset_val"]["preload"] = False
    return config


def build_parser() -> arguments.ArgParser:
    parser = arguments.ArgParser(description=__doc__)
    arguments.add_default_args(parser)
    arguments.add_exp_identifier_args(parser)
    arguments.add_trainer_args(parser, dataset_path=False)
    add_mart_args(parser)
    parser.add_argument("--load_model", type=str, default=None,
                        help="Load model from a reference-layout .pth.")
    parser.add_argument("--print_model", action="store_true",
                        help="Print model")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu.")
    return parser


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Run the CLI; returns one result dict per run: where the model and
    the batches were, and for a validation the metrics, the translation
    and metrics files and the per-batch timings of the eval step and the
    decode with the decode's forwards and host reads; for training the epochs trained, their train videos/s, the
    per-step wall ms, the models dir and the last epoch's metrics file
    (every epoch's meters); `train_unit` says what the train throughput
    counts: videos, or sentences in the single-sentence layout."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # full f32 products (no TF32), so the card agrees with the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    exp_group, exp_name, config_file = \
        arguments.setup_experiment_identifier_from_args(args, EXP_TYPE)
    config = load_yaml_config_file(config_file)
    config = arguments.update_config_from_args(config, args)
    config = update_mart_config_from_args(config, args)
    cfg = MartConfig(config)
    if args.print_config:
        print(cfg)
    mesh = pmesh.get_mesh(cfg.mesh_shape, device.type)
    try:
        return _run(args, cfg, exp_group, exp_name, mesh)
    finally:
        pmesh.destroy(mesh)


def _run(args, cfg: MartConfig, exp_group: str, exp_name: str,
         mesh: pmesh.Mesh) -> List[Dict[str, Any]]:
    device = mesh.device
    if cfg.random_seed is None:
        cfg.random_seed = pmesh.broadcast_object(
            mesh, random.randint(0, 2 ** 15))
        print(f"Random seed: {cfg.random_seed}")

    train_set, _, train_loader, val_loader = \
        create_mart_datasets_and_loaders(
            cfg, args.coot_feat_dir, args.annotations_dir,
            args.video_feature_dir, seed=cfg.random_seed, mesh=mesh)

    results = []
    for run_number in range(args.start_run, args.start_run + args.num_runs):
        run_name = f"{args.run_name}{run_number}"
        mgr = build_mart_model_manager(
            cfg, len(train_set.word2idx), device, seed=cfg.random_seed,
            cache_dir=args.cache_dir)
        if args.print_model:
            print(mgr.model)
        trainer = MartTrainer(
            cfg, mgr, exp_group, exp_name, run_name, len(train_loader),
            log_dir=args.log_dir, annotations_dir=args.annotations_dir,
            reset=args.reset,
            load_best=args.load_best or (args.validate
                                         and args.load_epoch is None),
            load_epoch=args.load_epoch, load_model=args.load_model,
            is_test=args.validate, mesh=mesh)
        try:
            if args.validate:
                results.append(_validate(args, cfg, trainer, val_loader))
            else:
                results.append(_train(cfg, trainer, train_loader,
                                      val_loader))
        except BaseException:
            trainer.logger.exception("Run aborted by uncaught exception:")
            raise
        results[-1]["model_device"] = next(mgr.model.parameters()).device
        results[-1]["batch_device"] = trainer.last_batch_device
        trainer.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return results


def _validate(args, cfg: MartConfig, trainer: MartTrainer,
              val_loader) -> Dict[str, Any]:
    if not trainer.load and not args.ignore_untrained:
        raise ValueError(
            "Validating an untrained model! No checkpoints were loaded. "
            "Add --ignore_untrained to validate anyway.")
    loss, score, _, metrics = trainer.validate_epoch(val_loader)
    epoch = trainer.state.current_epoch
    result = {
        "metrics": metrics, "val_loss": loss, "val_score": score,
        "translation_file": trainer.exp.get_translation_files(
            epoch, cfg.dataset_val.split),
        "metrics_file": trainer.exp.path_base / f"val_ep_{epoch}.json",
        "num_batches": len(val_loader),
        "eval_ms": list(trainer.val_timings["eval_ms"]),
        "decode_ms": list(trainer.val_timings["decode_ms"]),
        "forwards": list(trainer.val_timings["forwards"]),
        "host_reads": list(trainer.val_timings["host_reads"]),
        "val_seconds": trainer.state.time_val,
    }
    print(f"Validation: {len(val_loader)} batches in "
          f"{trainer.state.time_val:.2f} s; eval step "
          f"{np.median(result['eval_ms']):.1f} ms, decode "
          f"{np.median(result['decode_ms']):.1f} ms per batch (median)",
          flush=True)
    return result


def _train(cfg: MartConfig, trainer: MartTrainer, train_loader,
           val_loader) -> Dict[str, Any]:
    first_epoch = trainer.state.current_epoch
    trainer.train_model(train_loader, val_loader)
    timings = trainer.train_timings
    result = {
        "epochs": list(range(first_epoch, trainer.state.current_epoch)),
        "steps_per_epoch": len(train_loader),
        "train_videos_per_s": list(timings["epoch_videos_per_s"]),
        "train_unit": "sentences" if trainer.single else "videos",
        "step_ms": list(timings["step_ms"]),
        "total_step": trainer.state.total_step,
        "models_dir": trainer.exp.path_models,
        "metrics_file": trainer.exp.get_metrics_epoch_file(
            trainer.state.current_epoch - 1),
    }
    if result["step_ms"]:
        print(f"Training: {len(result['epochs'])} epochs of "
              f"{len(train_loader)} steps; step "
              f"{np.median(result['step_ms']):.1f} ms (median), train "
              f"{result['train_unit']}/s by epoch "
              f"{[round(v, 2) for v in result['train_videos_per_s']]}",
              flush=True)
    return result


if __name__ == "__main__":
    main()
