"""
Host-side LR scheduling: per-step/per-epoch warmup + reduce-on-plateau driven
by the trainer's "has_improved" signal.

Copy of coot_videotext_tpu/train/schedule.py (reference
nntrainer/lr_scheduler.py: LRScheduler :103, ConstantLR :329, NewROPWarmup
:365); pure Python, so the port keeps its own copy. The train step takes
`current_lr` as a float each step.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from coot_videotext_tpu_torch.config.base import (
    SchedulerConfig, SchedulerConst, SchedulerWarmupConst)


def make_lr_scheduler(cfg: SchedulerConfig, base_lr: float, num_epochs: int,
                      train_loader_length: int,
                      logger: Optional[logging.Logger] = None
                      ) -> "LRScheduler":
    """Scheduler factory (reference lr_scheduler.py:23)."""
    if logger is None:
        logger = logging.getLogger(__name__)
    if cfg.name == SchedulerConst.NONE or cfg.name == SchedulerConst.CONST:
        return ConstantLR(base_lr, cfg, num_epochs, train_loader_length,
                          logger)
    if cfg.name == SchedulerConst.REDUCE_OPW:
        return NewROPWarmup(base_lr, cfg, num_epochs, train_loader_length,
                            logger)
    raise NotImplementedError(f"LR Scheduler {cfg.name} unknown")


class LRScheduler:
    """
    Base scheduler: call step() after every training step and
    step_epoch(is_val, has_improved) after every epoch. `current_lr` holds
    the lr to feed into the train step.
    """

    def __init__(self, base_lr: float, cfg: SchedulerConfig, num_epochs: int,
                 train_loader_length: int, logger: logging.Logger) -> None:
        self.base_lr = float(base_lr)
        self.cfg = cfg
        self.num_epochs = num_epochs
        self.num_steps_per_train_epoch = train_loader_length
        self.logger = logger
        self.current_lr = self.base_lr
        self.old_lr = self.base_lr
        self.current_global_step = -1
        self.current_epoch = -1
        self.step()
        self.step_epoch(False, False)

    # ---------- to implement ----------

    def get_lr_from_step(self) -> float:
        raise NotImplementedError

    def get_lr_from_epoch(self, is_val: bool, has_improved: bool) -> float:
        raise NotImplementedError

    # ---------- public ----------

    def state_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if k not in ("cfg", "logger")}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)

    def step(self) -> None:
        """Per-train-step hook with step-sync assertion (reference :215)."""
        self.current_global_step += 1
        lo = self.current_epoch * self.num_steps_per_train_epoch
        hi = (self.current_epoch + 1) * self.num_steps_per_train_epoch
        assert lo < self.current_global_step <= hi, (
            f"Scheduler step {self.current_global_step} out of sync with "
            f"epoch {self.current_epoch} "
            f"({self.num_steps_per_train_epoch} steps/epoch)")
        if self._is_warmup():
            self._apply_warmup()
            return
        self.old_lr = self.current_lr
        self.current_lr = self.get_lr_from_step()

    def step_epoch(self, is_val: bool, has_improved: bool) -> None:
        """Per-epoch hook."""
        self.current_epoch += 1
        if self._is_warmup():
            self._apply_warmup()
            return
        self.old_lr = self.current_lr
        self.current_lr = self.get_lr_from_epoch(is_val, has_improved)

    # ---------- internals ----------

    def _is_warmup(self) -> bool:
        if self.cfg.warmup_type == SchedulerWarmupConst.NONE:
            return False
        assert self.cfg.warmup_type in (SchedulerWarmupConst.EPOCH,
                                        SchedulerWarmupConst.STEP), (
            f"Unknown warmup type {self.cfg.warmup_type}")
        return self.current_epoch < self.cfg.warmup_epochs

    def _apply_warmup(self) -> None:
        if self.cfg.warmup_type == SchedulerWarmupConst.EPOCH:
            factor = (self.current_epoch + 1) / max(self.cfg.warmup_epochs, 1)
        else:  # STEP
            factor = (self.current_global_step + 1) / (
                self.cfg.warmup_epochs * self.num_steps_per_train_epoch + 1)
        self.old_lr = self.current_lr
        self.current_lr = factor * self.base_lr


class ConstantLR(LRScheduler):
    """Constant LR (after warmup), reference :329."""

    def get_lr_from_step(self) -> float:
        return self.base_lr

    def get_lr_from_epoch(self, is_val: bool, has_improved: bool) -> float:
        return self.base_lr


class NewROPWarmup(LRScheduler):
    """Reduce-on-plateau with warmup (reference :365-458)."""

    def __init__(self, base_lr: float, cfg: SchedulerConfig, num_epochs: int,
                 train_loader_length: int, logger: logging.Logger) -> None:
        self.reduce_steps = 0
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        super().__init__(base_lr, cfg, num_epochs, train_loader_length,
                         logger)

    def get_lr_from_step(self) -> float:
        return self.current_lr

    def get_lr_from_epoch(self, is_val: bool, has_improved: bool) -> float:
        print_reduction = False
        if is_val:
            if has_improved:
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
                self.num_bad_epochs = 0
            if self.num_bad_epochs > self.cfg.rop_patience:
                self.reduce_steps += 1
                self.cooldown_counter = self.cfg.rop_cooldown
                self.num_bad_epochs = 0
                if not (self.cfg.rop_factor ** (self.reduce_steps - 1)
                        < self.cfg.rop_min_lr_factor):
                    print_reduction = True
        factor = max(self.cfg.rop_factor ** self.reduce_steps,
                     self.cfg.rop_min_lr_factor)
        new_lr = self.base_lr * factor
        if print_reduction:
            self.logger.info(
                f"E:{self.current_epoch} (scheduler) On Plateau: "
                f"Reduce LR to {new_lr}")
        return new_lr
