"""
Base trainer: the host-side experiment lifecycle.

Port of coot_videotext_tpu/train/trainer_base.py (reference
nntrainer/trainer_base.py:25-765): checkpoint auto-load best/last/epoch/file
(:144-176), early stopping (:285), val scheduling (:312), best-epoch compare
with rel/abs threshold (:632), the per-epoch and per-step hooks (:364-630),
checkpoint save/load/cleanup (:672-753, with a subclass's own files of
an epoch, `get_files_for_cleanup`), so the trainerstate and metrics
files keep the reference's schema. The device is one torch device; device
memory is read with torch.cuda.memory_allocated.

Under a data-parallel mesh (parallel/mesh.py; JAX builds its mesh here,
:70) each rank runs the whole lifecycle on its rows, and only rank 0
writes: the experiment dirs (a reset included), the log file, the config,
the trainerstate, the metrics, the checkpoints and their cleanup. Every
rank reads them back; barriers keep the reads after rank 0's writes. The
step meter counts global steps (one per global batch).

Subclasses implement train_model / validate_epoch and the four state
accessors (get/set model and optimizer state).
"""

from __future__ import annotations

import datetime
import logging
import resource
from pathlib import Path
from timeit import default_timer as timer
from typing import Any, List, Optional, Tuple

import torch

from coot_videotext_tpu_torch.config.base import BaseTrainerState
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.train import checkpoint as ckpt
from coot_videotext_tpu_torch.train.schedule import LRScheduler
from coot_videotext_tpu_torch.utils import yaml_utils
from coot_videotext_tpu_torch.utils.experiments import ExperimentFilesHandler
from coot_videotext_tpu_torch.utils.general import (
    LOGGER_NAME, MetricComparisonConst, TrainerPathConst, create_logger,
    remove_handlers)
from coot_videotext_tpu_torch.utils.metrics import DefaultMetricsConst as M
from coot_videotext_tpu_torch.utils.metrics import MetricsWriter


class BaseTrainer:
    """Host-side training lifecycle (reference BaseTrainer :25)."""

    def __init__(self, cfg, model_mgr, exp_group: str, exp_name: str,
                 run_name: str, train_loader_length: int, model_type: str,
                 *, load_model: Optional[str] = None, load_best: bool = False,
                 load_epoch: Optional[int] = None, reset: bool = False,
                 is_test: bool = False,
                 log_dir: str = TrainerPathConst.DIR_EXPERIMENTS,
                 exp_files_handler: Optional[ExperimentFilesHandler] = None,
                 mesh: Optional[pmesh.Mesh] = None) -> None:
        self.cfg = cfg
        self.model_mgr = model_mgr
        self.device: torch.device = model_mgr.device
        self.mesh = mesh if mesh is not None else pmesh.single(self.device)
        self.is_writer = self.mesh.is_writer
        self.is_test = is_test
        # subclasses may pass their own handler (the caption trainer's
        # adds the caption/ dir of the translations)
        self.exp = exp_files_handler or ExperimentFilesHandler(
            model_type, exp_group, exp_name, run_name, log_dir=log_dir)
        if self.is_writer:
            self.exp.setup_dirs(reset=reset)
        pmesh.barrier(self.mesh)
        self.logger: logging.Logger = create_logger(
            LOGGER_NAME, log_dir=self.exp.path_logs if self.is_writer else "")
        self.logger.info(
            f"Experiment: {exp_group}/{exp_name}/{run_name} type "
            f"{model_type} in {self.exp.path_base} on {self.device}; "
            f"compute dtype {cfg.compute_dtype}; rank {self.mesh.rank} of "
            f"{self.mesh.world}")
        self.state = BaseTrainerState()
        self.metrics = MetricsWriter(self.exp)
        self.logger.info(f"Random seed: {self.cfg.random_seed}")
        if self.is_writer:
            yaml_utils.dump_yaml_config_file(
                self.exp.path_base / "config.yaml", self.cfg.config_orig)

        self.load_model = load_model
        self.load, self.load_ep = self._resolve_auto_load(load_epoch,
                                                          load_best)

        # default meters (reference :179-201)
        self.metrics.add_meter(M.TRAIN_EPOCH, use_avg=False)
        self.metrics.add_meter(M.TIME_TOTAL, use_avg=False)
        self.metrics.add_meter(M.TIME_VAL, use_avg=False)
        self.metrics.add_meter(M.VAL_LOSS, use_avg=False)
        self.metrics.add_meter(M.VAL_BEST_FIELD, use_avg=False)
        self.metrics.add_meter(M.TRAIN_LR, per_step=True, use_avg=False)
        self.metrics.add_meter(M.TRAIN_GRAD_CLIP, per_step=True,
                               reset_avg_each_epoch=True)
        self.metrics.add_meter(M.TRAIN_LOSS, per_step=True,
                               reset_avg_each_epoch=True)
        self.metrics.add_meter(M.PROFILE_GPU_MEM_USED, per_step=True)
        self.metrics.add_meter(M.PROFILE_RAM_USED, per_step=True)
        for name in (M.TIME_STEP_FORWARD, M.TIME_STEP_BACKWARD,
                     M.TIME_STEP_TOTAL, M.TIME_STEP_OTHER):
            self.metrics.add_meter(name, per_step=True, use_value=False)

        self.train_loader_length = train_loader_length
        self.lr_scheduler: Optional[LRScheduler] = None  # set by subclass
        self.timer_step = 0.0
        self.timer_step_forward = 0.0
        self.timer_step_backward = 0.0
        self.timer_train_epoch = 0.0
        self.timer_val_epoch = 0.0
        self.timedelta_step_forward = 0.0
        self.timedelta_step_backward = 0.0

    def _resolve_auto_load(self, load_epoch, load_best) -> Tuple[bool, int]:
        """(load, epoch): an explicit model file beats everything (epoch
        -1), then a requested epoch, then the best validated epoch, then
        the newest checkpoint; a fresh experiment starts from scratch
        (reference :144-176)."""
        if self.load_model:
            if load_epoch is not None:
                raise ValueError(
                    "--load_model warmstarts from a file; it cannot be "
                    "combined with --load_epoch.")
            return True, -1
        known = self.exp.get_existing_checkpoints()
        if not known:
            self.logger.info("No checkpoints found, starting from scratch.")
            return False, -1
        if load_epoch is not None:
            if load_best:
                raise ValueError(
                    "--load_epoch and --load_best are mutually exclusive.")
            return True, load_epoch
        if load_best:
            epoch = self.exp.find_best_epoch()
            self.logger.info(f"Best ckpt to load: {epoch}")
            return True, epoch
        self.logger.info(f"Last ckpt to load: {known[-1]}")
        return True, known[-1]

    # ---------- must override ----------

    def train_model(self, train_loader, val_loader) -> None:
        raise NotImplementedError

    def validate_epoch(self, val_loader, **kwargs):
        raise NotImplementedError

    def get_model_state(self) -> Any:
        raise NotImplementedError

    def set_model_state(self, state: Any) -> None:
        raise NotImplementedError

    def get_opt_state(self) -> Any:
        raise NotImplementedError

    def set_opt_state(self, state: Any) -> None:
        raise NotImplementedError

    def get_files_for_cleanup(self, _epoch: int) -> List[Path]:
        """A subclass's own files of an epoch, deleted with its
        checkpoint."""
        return []

    # ---------- epoch decisions ----------

    def check_early_stop(self) -> bool:
        """Early stop after N bad epochs (reference :285)."""
        current_epoch = self.state.current_epoch - 1
        best_epoch = self.exp.find_best_epoch()
        if best_epoch == -1:
            best_epoch = current_epoch
        bad_epochs = current_epoch - best_epoch
        self.logger.info(
            f"Experiment ---------- {self.exp.exp_group}/"
            f"{self.exp.exp_name}/{self.exp.run_name} ---------- epoch "
            f"current/best/bad: {current_epoch}/{best_epoch}/{bad_epochs}")
        if 0 <= self.cfg.val.det_best_terminate_after <= bad_epochs:
            self.logger.info(
                f"No improvement since {bad_epochs} epochs, end of training.")
            return True
        return False

    def check_is_val_epoch(self) -> bool:
        """Validation scheduling (reference :312)."""
        do_val = (self.state.current_epoch % self.cfg.val.val_freq == 0
                  and self.cfg.val.val_freq > -1
                  and self.state.current_epoch >= self.cfg.val.val_start)
        return do_val or (self.state.current_epoch
                          == self.cfg.train.num_epochs)

    def check_is_new_best(self, result: float) -> bool:
        """Update best-field bookkeeping (reference :336)."""
        old_best = self.state.det_best_field_best
        is_best = self._is_better(result, old_best)
        self.state.det_best_field_current = result
        if is_best:
            self.state.det_best_field_best = result
            self.logger.info(f"New best: {result:.5f}")
        else:
            self.logger.info(f"Validation score {result:.5f} (best "
                             f"{old_best:.5f})")
        return is_best

    def _is_better(self, current: float, best: Optional[float]) -> bool:
        """Rel/abs threshold compare (reference :632)."""
        if best is None:
            return True
        val = self.cfg.val
        rel = val.det_best_threshold_mode == \
            MetricComparisonConst.VAL_DET_BEST_TH_MODE_REL
        thresh = val.det_best_threshold_value
        if val.det_best_compare_mode == \
                MetricComparisonConst.VAL_DET_BEST_MODE_MIN:
            return current < (best * (1 - thresh) if rel else best - thresh)
        if val.det_best_compare_mode == \
                MetricComparisonConst.VAL_DET_BEST_MODE_MAX:
            return current > (best * (1 + thresh) if rel else best + thresh)
        raise ValueError(f"Unknown compare mode {val.det_best_compare_mode}")

    # ---------- experiment-level hooks ----------

    def hook_post_init(self) -> None:
        """Load the requested checkpoint (reference :364)."""
        if not self.load:
            return
        if self.load_model:
            self.logger.info(f"Loading model from {self.load_model}")
            self.set_model_state(ckpt.load(self.load_model))
            return
        self.logger.info(f"Loading Ep {self.load_ep}.")
        self._load_checkpoint(self.load_ep)
        if not self.is_test:
            # loaded epoch N -> now training epoch N+1 (reference :385-388)
            self.state.current_epoch += 1

    def hook_pre_train(self) -> None:
        self.state.start_epoch = self.state.current_epoch
        self.logger.info(f"Training from {self.state.current_epoch} to "
                         f"{self.cfg.train.num_epochs}")

    def hook_post_train(self) -> None:
        self.logger.info(
            f"In total, training {self.state.current_epoch} epochs took "
            f"{self.state.time_total:.3f}s "
            f"({self.state.time_total - self.state.time_val:.3f}s train / "
            f"{self.state.time_val:.3f}s val)")

    # ---------- epoch hooks ----------

    def hook_pre_train_epoch(self) -> None:
        self.timer_train_epoch = timer()
        self.timer_step = timer()
        self.metrics.hook_epoch_start()
        now = str(datetime.datetime.now()).split(".")[0]
        self.logger.info(f"{now} ---------- Training epoch: "
                         f"{self.state.current_epoch}")

    def hook_pre_val_epoch(self) -> None:
        self.timer_val_epoch = timer()
        self.timer_step = timer()

    def hook_post_val_epoch(self, val_loss: float, is_best: bool) -> None:
        self.state.time_val += timer() - self.timer_val_epoch
        self.metrics.update_meter(M.VAL_LOSS, val_loss)
        self.metrics.update_meter(M.VAL_BEST_FIELD,
                                  self.state.det_best_field_current)
        self.state.infos_val_epochs.append(self.state.current_epoch)
        self.state.infos_val_steps.append(self.state.total_step)
        self.state.infos_val_is_good.append(int(is_best))

    def hook_post_train_and_val_epoch(self, is_val: bool,
                                      has_improved: bool) -> None:
        self.state.time_total += timer() - self.timer_train_epoch
        if self.lr_scheduler is not None:
            self.lr_scheduler.step_epoch(is_val, has_improved)
        self.metrics.update_meter(M.TIME_TOTAL, self.state.time_total)
        self.metrics.update_meter(M.TIME_VAL, self.state.time_val)
        self.metrics.update_meter(M.TRAIN_EPOCH, self.state.current_epoch)
        time_total = max(self.metrics.meters[M.TIME_STEP_TOTAL].avg, 1e-9)
        parts = []
        for field in (M.TIME_STEP_FORWARD, M.TIME_STEP_BACKWARD,
                      M.TIME_STEP_OTHER):
            val = self.metrics.meters[field].avg
            parts += [str(field).split("_")[-1], f"{val * 1000:.2f}ms",
                      f"{val / time_total:.1%}"]
        self.logger.info(f"Step time: Total {time_total * 1000:.0f}ms "
                         + " ".join(parts))
        self.metrics.feed_metrics(False, self.state.total_step,
                                  self.state.current_epoch)
        if self.is_writer:
            self._save_checkpoint()
            self._cleanup_files()
        pmesh.barrier(self.mesh)
        self.state.current_epoch += 1

    # ---------- step hooks ----------

    def hook_pre_step_timer(self) -> None:
        self.timer_step_forward = timer()

    def hook_post_forward_step_timer(self) -> None:
        self.timer_step_backward = timer()
        self.timedelta_step_forward = (self.timer_step_backward
                                       - self.timer_step_forward)

    def hook_post_step(self, epoch_step: int, loss: float, lr: float,
                       grad_norm: Optional[float] = None) -> None:
        """Log, profile, feed meters, step scheduler (reference :523)."""
        self.state.last_grad_norm = (float(grad_norm)
                                     if grad_norm is not None else 0.0)
        total_step_time = timer() - self.timer_step
        other_t = (total_step_time - self.timedelta_step_forward
                   - self.timedelta_step_backward)
        self.metrics.update_meter(M.TIME_STEP_FORWARD,
                                  self.timedelta_step_forward)
        self.metrics.update_meter(M.TIME_STEP_BACKWARD,
                                  self.timedelta_step_backward)
        self.metrics.update_meter(M.TIME_STEP_TOTAL, total_step_time)
        self.metrics.update_meter(M.TIME_STEP_OTHER, other_t)
        self.timer_step = timer()

        log_step = self.cfg.logging.step_train
        if log_step > 0 and epoch_step % log_step == 0:
            gn_str = (f" Grad {self.state.last_grad_norm:.3f}"
                      if grad_norm is not None else "")
            self.logger.info(
                f"E{self.state.current_epoch}[{epoch_step:4d}/"
                f"{self.train_loader_length}] T {total_step_time:.3f}s "
                f"LR {lr:.1e} L {loss:.4f}{gn_str}")
        gpu_step = self.cfg.logging.step_gpu
        if gpu_step > 0 and epoch_step % gpu_step == 0:
            self.profile_device()
        self.metrics.update_meter(M.TRAIN_LR, lr)
        self.metrics.update_meter(M.TRAIN_LOSS, loss)
        if grad_norm is not None:
            self.metrics.update_meter(M.TRAIN_GRAD_CLIP,
                                      self.state.last_grad_norm)
        self.state.epoch_step = epoch_step
        self.state.total_step += 1
        self.metrics.feed_metrics(True, self.state.total_step,
                                  self.state.current_epoch)
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()

    def profile_device(self) -> None:
        """Device memory in use and the host's peak RSS (replaces GPUtil,
        reference trainer_base.py:571-602)."""
        if self.device.type == "cuda":
            self.metrics.update_meter(
                M.PROFILE_GPU_MEM_USED,
                torch.cuda.memory_allocated(self.device) / 1024 ** 3)
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.metrics.update_meter(M.PROFILE_RAM_USED, peak_kb / 1024 ** 2)

    # ---------- checkpointing ----------

    def _save_checkpoint(self) -> None:
        """Save the epoch's artifacts (reference :672); rank 0 calls it."""
        epoch = self.state.current_epoch
        self.state.save(self.exp.get_trainerstate_file(epoch))
        self.metrics.save_epoch(epoch)
        ckpt.save(self.exp.get_models_file(epoch), self.get_model_state())
        if self.cfg.saving.save_opt_state:
            ckpt.save(self.exp.get_optimizer_file(epoch),
                      self.get_opt_state())
            if self.lr_scheduler is not None:
                yaml_utils.dump_json(self.lr_scheduler.state_dict(),
                                     self.exp.get_scheduler_file(epoch))

    def _load_checkpoint(self, epoch: int) -> None:
        """Load the epoch's artifacts (reference :693)."""
        self.state.load(self.exp.get_trainerstate_file(epoch))
        self.metrics.load_epoch(epoch)
        self.set_model_state(ckpt.load(self.exp.get_models_file(epoch)))
        if self.is_test:
            self.logger.info(
                "Don't load optimizer and scheduler during inference.")
            return
        opt_file = self.exp.get_optimizer_file(epoch)
        if opt_file.is_file():
            self.set_opt_state(ckpt.load(opt_file))
        sched_file = self.exp.get_scheduler_file(epoch)
        if self.lr_scheduler is not None and sched_file.is_file():
            self.lr_scheduler.load_state_dict(yaml_utils.load_json(
                sched_file))

    def _cleanup_files(self) -> None:
        """Keep best + last + keep_freq checkpoints (reference :717)."""
        ep_nums = self.exp.get_existing_checkpoints()
        if not ep_nums:
            return
        keep = {self.exp.find_best_epoch(), ep_nums[-1]}
        for ep_num in ep_nums:
            if ep_num in keep or (self.cfg.saving.keep_freq > 0 and
                                  ep_num % self.cfg.saving.keep_freq == 0):
                continue
            for file in [self.exp.get_models_file(ep_num),
                         self.exp.get_optimizer_file(ep_num),
                         self.exp.get_trainerstate_file(ep_num),
                         self.exp.get_scheduler_file(ep_num),
                         self.exp.get_metrics_epoch_file(ep_num),
                         self.exp.get_metrics_step_file(ep_num),
                         *self.get_files_for_cleanup(ep_num)]:
                Path(file).unlink(missing_ok=True)

    def close(self) -> None:
        """Close the run's log file."""
        remove_handlers(self.logger)
