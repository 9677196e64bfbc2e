"""
Retrieval trainer: COOT training and validation on one torch device.

Port of coot_videotext_tpu/tasks/retrieval/trainer.py (reference
coot/trainer_retrieval.py:26-499): `train_model` :184, the per-step epoch
`_train_epoch_per_step` :232 and `validate_epoch` :317, which reuses
tasks/retrieval/validate.py. Deliberate differences:
    - per-step dispatch only: the scan-fused group step needs the device
      feature store (ROADMAP A7), so `train.steps_per_dispatch > 1` logs
      and dispatches per step, as the JAX trainer does without device
      sampling (:190-195);
    - batches are collated on the host and copied pinned and non-blocking;
    - the step's time is booked to the forward meter (the backward meter
      stays 0), as in the JAX trainer, whose jitted step covers both.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from coot_videotext_tpu_torch.data.retrieval_dataset import (
    RetrievalBatchLoader, to_device)
from coot_videotext_tpu_torch.tasks.retrieval.config import (
    CootMetersConst as CMeters, ExperimentTypesConst, RetrievalConfig)
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    TrainState, retrieval_train_step)
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
                 is_test: bool = False) -> None:
        super().__init__(
            cfg, model_mgr, exp_group, exp_name, run_name,
            train_loader_length, ExperimentTypesConst.RETRIEVAL,
            load_model=load_model, load_best=load_best,
            load_epoch=load_epoch, reset=reset, is_test=is_test,
            log_dir=log_dir)
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
        seed = cfg.random_seed if cfg.random_seed is not None else 0
        self.train_state = TrainState(
            model=model,
            optimizer=make_optimizer(cfg.optimizer,
                                     dict(model.named_parameters())),
            seeds=torch.Generator().manual_seed(seed),
            cc=torch.Generator(self.device).manual_seed(seed))
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

    # ---------- state accessors for checkpointing ----------

    def get_model_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return self.model_mgr.state_dict()

    def set_model_state(self, state) -> None:
        self.model_mgr.load_state(state)

    def get_opt_state(self) -> Dict[str, Any]:
        ts = self.train_state
        return {"optimizer": ts.optimizer.state_dict(), "step": ts.step,
                "seeds": ts.seeds.get_state(), "cc": ts.cc.get_state()}

    def set_opt_state(self, state: Dict[str, Any]) -> None:
        ts = self.train_state
        ts.optimizer.load_state_dict(state["optimizer"])
        ts.step = int(state["step"])
        ts.seeds.set_state(state["seeds"])
        ts.cc.set_state(state["cc"])

    # ---------- training ----------

    def train_model(self, train_loader: RetrievalBatchLoader,
                    val_loader: RetrievalBatchLoader) -> None:
        self.hook_pre_train()
        if self.cfg.train.steps_per_dispatch > 1:
            self.logger.warning(
                "train.steps_per_dispatch > 1 needs the device-resident "
                "pipeline, which is not ported yet; dispatching per step.")
        for _epoch in range(self.state.current_epoch,
                            self.cfg.train.num_epochs):
            if self.check_early_stop():
                break
            train_loader.set_epoch(self.state.current_epoch)
            self.hook_pre_train_epoch()
            self._train_epoch_per_step(train_loader)
            is_val = self.check_is_val_epoch()
            has_improved = False
            if is_val:
                _loss, _score, has_improved = self.validate_epoch(
                    val_loader)
            self.hook_post_train_and_val_epoch(is_val, has_improved)
        self.hook_post_train()

    def _train_epoch_per_step(self, train_loader: RetrievalBatchLoader
                              ) -> None:
        for step, host_batch in enumerate(train_loader):
            batch = to_device(host_batch, self.device)
            self.hook_pre_step_timer()
            lr = self.lr_scheduler.current_lr
            metrics = retrieval_train_step(
                self.train_state, batch, lr=lr,
                clip_gradient=self.cfg.train.clip_gradient,
                compute_dtype=self.model_mgr.train_dtype, **self._loss_kw)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            self.hook_post_forward_step_timer()
            self.metrics.update_meter(CMeters.TRAIN_LOSS_CONTRASTIVE,
                                      metrics["loss_contrastive"])
            self.metrics.update_meter(CMeters.TRAIN_LOSS_CC,
                                      metrics["loss_cc"])
            self.hook_post_step(step, metrics["loss_total"], lr,
                                grad_norm=metrics.get("grad_norm"))

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
        if save_embs or self.cfg.val.save_embeddings:
            emb_file = (self.exp.path_embeddings /
                        f"embeddings_{self.state.current_epoch}.h5")
        results = validate_retrieval(
            self.model_mgr.model, self.cfg, val_loader, self.device,
            compute_dtype=self.model_mgr.val_dtype, val_clips=val_clips,
            emb_file=emb_file,
            generator=torch.Generator(self.device).manual_seed(42),
            logger=self.logger)
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
