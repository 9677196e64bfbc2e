"""
Retrieval trainer: COOT training and validation on one torch device.

Port of coot_videotext_tpu/tasks/retrieval/trainer.py (reference
coot/trainer_retrieval.py:26-499): `train_model` :184, the per-step epoch
`_train_epoch_per_step` :232 with the loader modes of `_loader_mode` :104
(dense, slab, store and id batches; data/device_store.py `FeatureSource`),
each behind the prefetch pipeline (data/pipeline.py, JAX :235), the group
epoch `_train_epoch_scan` :258 and `validate_epoch` :317, which
reuses tasks/retrieval/validate.py.

With `train.steps_per_dispatch` K > 1 on id batches (the fully
device-resident path: `--preload_device --fixed_shapes`), each group of K
steps runs through `retrieval_train_group` (on the card, replays of a CUDA
graph of the step) and the host reads the group's metrics once. Elsewhere,
and while the scheduler's lr varies per step (a per-step warmup), the
trainer dispatches per step, as JAX does. A group's time is split evenly
over its steps in the meters. The checkpoint holds the optimizer (with its
device step count) and the seed state; a file without the seed state (an
earlier version's) restores it as the run seed advanced by the step count,
which is what an unbroken run holds. Deliberate differences:
    - host batches are copied pinned and non-blocking on a side stream,
      two batches ahead; the wait on the queue falls in the step meter's
      "other" time;
    - the step's time is booked to the forward meter (the backward meter
      stays 0), as in the JAX trainer, whose jitted step covers both.
Under a data-parallel mesh (parallel/mesh.py) every rank trains on its
rows of each global batch (JAX :99, :236, :340), the parameters are
broadcast from rank 0 once they are initialised or loaded, and
validation gathers the embeddings of the whole split on every rank; only
rank 0 writes files. Under a `model` axis (parallel/tp.py) the trainer
then shards the model and the optimizer by the rules, and its checkpoints
hold the whole tensors (gathered over the model group, sliced again on a
resume).
"""

from __future__ import annotations

import collections
from timeit import default_timer as timer
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.data.device_store import FeatureSource
from coot_videotext_tpu_torch.data.pipeline import prefetch
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    RetrievalBatchLoader)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.parallel.mesh import Mesh, broadcast_params
from coot_videotext_tpu_torch.parallel.tp import shard_model_for_tp
from coot_videotext_tpu_torch.tasks.retrieval.config import (
    CootMetersConst as CMeters, ExperimentTypesConst, RetrievalConfig)
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    TrainState, retrieval_train_group, retrieval_train_step)
from coot_videotext_tpu_torch.tasks.retrieval.validate import (
    validate_retrieval)
from coot_videotext_tpu_torch.train.optim import make_optimizer
from coot_videotext_tpu_torch.train.schedule import make_lr_scheduler
from coot_videotext_tpu_torch.train.trainer_base import BaseTrainer
from coot_videotext_tpu_torch.utils.general import TrainerPathConst

_MODALITY_KEYS = dict(zip(CMeters.RET_MODALITIES, ("v2p", "p2v", "c2s",
                                                   "s2c")))


class RetrievalTrainer(BaseTrainer):
    """COOT retrieval trainer (reference RetrievalTrainer :26)."""

    def __init__(self, cfg: RetrievalConfig,
                 model_mgr: RetrievalModelManager, exp_group: str,
                 exp_name: str, run_name: str, train_loader_length: int,
                 *, log_dir: str = TrainerPathConst.DIR_EXPERIMENTS,
                 load_model: Optional[str] = None, load_best: bool = False,
                 load_epoch: Optional[int] = None, reset: bool = False,
                 is_test: bool = False, mesh: Optional[Mesh] = None) -> None:
        super().__init__(
            cfg, model_mgr, exp_group, exp_name, run_name,
            train_loader_length, ExperimentTypesConst.RETRIEVAL,
            load_model=load_model, load_best=load_best,
            load_epoch=load_epoch, reset=reset, is_test=is_test,
            log_dir=log_dir, mesh=mesh)
        self.cfg: RetrievalConfig = cfg
        # loss meters (reference :87-103)
        self.metrics.add_meter(CMeters.VAL_LOSS_CC, use_avg=False)
        self.metrics.add_meter(CMeters.VAL_LOSS_CONTRASTIVE, use_avg=False)
        self.metrics.add_meter(CMeters.TRAIN_LOSS_CC, per_step=True,
                               use_avg=False)
        self.metrics.add_meter(CMeters.TRAIN_LOSS_CONTRASTIVE,
                               per_step=True, use_avg=False)
        for modality in CMeters.RET_MODALITIES:
            for metric in CMeters.RET_METRICS:
                metric_class = "val_base" if metric == "r1" else "val_ret"
                self.metrics.add_meter(f"{metric_class}/{modality}-{metric}",
                                       use_avg=False)

        # RAdam + reduce-on-plateau (reference :109-117)
        model = model_mgr.model
        self.seed = cfg.random_seed if cfg.random_seed is not None else 0
        self.train_state = TrainState(
            model=model,
            optimizer=make_optimizer(cfg.optimizer,
                                     dict(model.named_parameters())),
            seed=philox.seed_state(self.seed, self.device), mesh=self.mesh)
        # train steps dispatched one at a time ("step") and in groups
        self.dispatches: collections.Counter = collections.Counter()
        self.lr_scheduler = make_lr_scheduler(
            cfg.lr_scheduler, cfg.optimizer.lr, cfg.train.num_epochs,
            train_loader_length, self.logger)
        self.logger.info(f"Model: {model_mgr.count_parameters():,} "
                         f"parameters, train dtype {model_mgr.train_dtype}, "
                         f"val dtype {model_mgr.val_dtype}")
        self._loss_kw = dict(
            loss_weights=cfg.train.contrastive_loss_config.as_dict(),
            margin=cfg.train.contrastive_loss_config.margin,
            loss_cycle_cons=cfg.train.loss_cycle_cons)
        self.hook_post_init()
        broadcast_params(self.mesh, model.parameters())
        if self.mesh.tensor_parallel:
            self.train_state.tp = shard_model_for_tp(
                model, self.train_state.optimizer, None, self.mesh)

    # ---------- state accessors for checkpointing ----------

    def get_model_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{net: state_dict} of whole tensors (gathered over the model
        group under tensor parallelism)."""
        state = self.model_mgr.state_dict()
        tp = self.train_state.tp
        if tp is None:
            return state
        return {net: tp.gather(sd, f"{net}.") for net, sd in state.items()}

    def set_model_state(self, state) -> None:
        tp = self.train_state.tp
        if tp is not None:
            state = {net: tp.localize(sd, f"{net}.")
                     for net, sd in state.items()}
        self.model_mgr.load_state(state)

    def get_opt_state(self) -> Dict[str, Any]:
        ts = self.train_state
        opt = ts.optimizer.state_dict()
        if ts.tp is not None:
            opt.update(mu=ts.tp.gather(opt["mu"]), nu=ts.tp.gather(opt["nu"]))
        return {"optimizer": opt, "step": ts.step, "seed": ts.seed.clone()}

    def set_opt_state(self, state: Dict[str, Any]) -> None:
        """Restores an `optimizer_<ep>.pth` in place (a captured step keeps
        reading the same tensors). A file of an earlier version, without
        the seed state (it held CPU and device generators instead), gets
        the run seed advanced by its step count, as an unbroken run of this
        version would hold it."""
        ts = self.train_state
        opt = state["optimizer"]
        if ts.tp is not None:
            opt = dict(opt, mu=ts.tp.localize(opt["mu"]),
                       nu=ts.tp.localize(opt["nu"]))
        ts.optimizer.load_state_dict(opt)
        ts.step = int(state["step"])
        if "seed" in state:
            ts.seed.copy_(state["seed"])
        else:
            ts.seed.copy_(philox.seed_state(self.seed + ts.step))

    # ---------- training ----------

    def train_model(self, train_loader: RetrievalBatchLoader,
                    val_loader: RetrievalBatchLoader) -> None:
        self.hook_pre_train()
        k_dispatch = self.cfg.train.steps_per_dispatch
        group_capable = k_dispatch > 1 and train_loader.layout == "ids"
        if k_dispatch > 1 and not group_capable:
            self.logger.warning(
                "train.steps_per_dispatch > 1 needs the fully "
                "device-resident pipeline (preload_device + fixed shapes + "
                "sample_on_device: id batches); dispatching per step.")
        warned = False
        for _epoch in range(self.state.current_epoch,
                            self.cfg.train.num_epochs):
            if self.check_early_stop():
                break
            train_loader.set_epoch(self.state.current_epoch)
            self.hook_pre_train_epoch()
            # a group applies one lr to its K steps: dispatch per step
            # while a per-step warmup varies it
            use_group = group_capable and not (
                self.lr_scheduler is not None
                and self.lr_scheduler.lr_varies_per_step())
            if group_capable and not use_group and not warned:
                self.logger.info(
                    "Per-step warmup active: dispatching per step until the "
                    f"warmup ends, then in groups of {k_dispatch}.")
                warned = True
            if use_group:
                self._train_epoch_group(train_loader, k_dispatch)
            else:
                self._train_epoch_per_step(train_loader)
            is_val = self.check_is_val_epoch()
            has_improved = False
            if is_val:
                _loss, _score, has_improved = self.validate_epoch(
                    val_loader)
            self.hook_post_train_and_val_epoch(is_val, has_improved)
        self.hook_post_train()

    def _source(self, train_loader: RetrievalBatchLoader) -> FeatureSource:
        ds_cfg = self.cfg.dataset_train
        return FeatureSource.of(train_loader, ds_cfg.frames_noise,
                                ds_cfg.words_noise)

    def _train_epoch_per_step(self, train_loader: RetrievalBatchLoader
                              ) -> None:
        source = self._source(train_loader)
        for step, (tensors, host) in enumerate(prefetch(train_loader,
                                                        self.device)):
            batch = {**host, **tensors}
            self.hook_pre_step_timer()
            lr = self.lr_scheduler.current_lr
            metrics = retrieval_train_step(
                self.train_state, batch, lr=lr,
                clip_gradient=self.cfg.train.clip_gradient,
                compute_dtype=self.model_mgr.train_dtype, source=source,
                **self._loss_kw)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            self.dispatches["step"] += 1
            self.hook_post_forward_step_timer()
            self._book_step(step, metrics, lr)

    def _book_step(self, step: int, metrics: Dict[str, float],
                   lr: float) -> None:
        self.metrics.update_meter(CMeters.TRAIN_LOSS_CONTRASTIVE,
                                  metrics["loss_contrastive"])
        self.metrics.update_meter(CMeters.TRAIN_LOSS_CC, metrics["loss_cc"])
        self.hook_post_step(step, metrics["loss_total"], lr,
                            grad_norm=metrics.get("grad_norm"))

    def _train_epoch_group(self, train_loader: RetrievalBatchLoader,
                           k: int) -> None:
        """One epoch in groups of k id batches (JAX `_train_epoch_scan`
        :258): one `retrieval_train_group` call and one read of its
        metrics per group; the group's time is split evenly over its
        steps, in the forward meter and in the step total."""
        source = self._source(train_loader)
        bsz = train_loader.local_batch
        batches = list(train_loader)  # (B,) ids each: a few hundred bytes
        for g0 in range(0, len(batches), k):
            group = batches[g0:g0 + k]
            ids = np.zeros((k, bsz), np.int32)
            valid = np.zeros((k, bsz), bool)
            for i, b in enumerate(group):
                ids[i] = b["dp_idx"]
                valid[i] = b["batch_valid"]
            self.hook_pre_step_timer()
            lr = self.lr_scheduler.current_lr
            metrics = retrieval_train_group(
                self.train_state, ids, valid, len(group), lr=lr,
                clip_gradient=self.cfg.train.clip_gradient,
                compute_dtype=self.model_mgr.train_dtype, source=source,
                **self._loss_kw)
            names = list(metrics)
            values = torch.stack([metrics[n] for n in names]).cpu().numpy()
            self.dispatches["group"] += 1
            self.hook_post_forward_step_timer()
            self.timedelta_step_forward /= len(group)
            group_time = timer() - self.timer_step
            for i in range(len(group)):
                self.timer_step = timer() - group_time / len(group)
                self._book_step(g0 + i, {n: float(values[j, i])
                                         for j, n in enumerate(names)}, lr)

    # ---------- validation ----------

    def validate_epoch(self, val_loader: RetrievalBatchLoader, *,
                       val_clips: bool = False, save_embs: bool = False
                       ) -> Tuple[float, float, bool]:
        """One validation epoch (reference :312). Returns
        (val_loss, val_score, is_best)."""
        self.hook_pre_val_epoch()
        val_clips = val_clips or (
            self.cfg.val.val_clips
            and self.state.current_epoch % self.cfg.val.val_clips_freq == 0)
        emb_file = None
        if (save_embs or self.cfg.val.save_embeddings) and self.is_writer:
            emb_file = (self.exp.path_embeddings /
                        f"embeddings_{self.state.current_epoch}.h5")
        results = validate_retrieval(
            self.model_mgr.model, self.cfg, val_loader, self.device,
            compute_dtype=self.model_mgr.val_dtype, val_clips=val_clips,
            emb_file=emb_file, cc_seed=42, logger=self.logger,
            mesh=self.mesh)
        self.metrics.update_meter(CMeters.VAL_LOSS_CONTRASTIVE,
                                  results["loss_contrastive"])
        self.metrics.update_meter(CMeters.VAL_LOSS_CC, results["loss_cc"])
        for modality, key in _MODALITY_KEYS.items():
            if key not in results:
                continue
            for metric in CMeters.RET_METRICS:
                metric_class = "val_base" if metric == "r1" else "val_ret"
                self.metrics.update_meter(
                    f"{metric_class}/{modality}-{metric}",
                    results[key][metric])
        is_best = self.check_is_new_best(results["val_score"])
        self.hook_post_val_epoch(results["loss_total"], is_best)
        return results["loss_total"], results["val_score"], is_best
