"""
The third experiment type, `mlp`: an MLP classifier on MNIST-like digits,
the example of how a new experiment type plugs into the trainer and the
workhorse of the integration tests (train, checkpoint, resume, reload,
bit-determinism).

Port of coot_videotext_tpu/examples/mlp_mnist.py (reference
nntrainer/examples/mlp_mnist.py:1-319) on the port's `trainer_base`,
`optim.Adam` and `schedule`: `make_synthetic_mnist` :34 (the same numpy
draws, so the same bytes), the loader :54, the config :94, `MLPModel`
:120 as an nn.Module (`fc1`, `fc2`; utils/param_bridge.py
`jax_mlp_params_to_state_dict` maps JAX's `Dense_0`, `Dense_1` onto
them), the manager :131 and the trainer :151. The model file is the
module's state dict; batches reach the device through data/pipeline.py.
The digits are synthetic (class-dependent patterns plus noise, 28 x 28):
the reference downloads MNIST. Under a data-parallel mesh
(parallel/mesh.py; JAX :206-243 shards each batch over `data`) each rank
takes its rows of every global batch; the weighted mean loss divides by
the global batch's weight, and the gradients and the validation sums are
summed over ranks, so every rank takes the one step of the global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coot_videotext_tpu_torch.config import base as trainer_configs
from coot_videotext_tpu_torch.data.pipeline import prefetch
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.train.optim import Adam
from coot_videotext_tpu_torch.train.schedule import make_lr_scheduler
from coot_videotext_tpu_torch.train.trainer_base import BaseTrainer
from coot_videotext_tpu_torch.utils.general import (
    ExperimentTypesConst, TrainerPathConst)

EXP_TYPE = ExperimentTypesConst.MLP


# ---------- data ----------

def make_synthetic_mnist(num_train: int = 512, num_val: int = 256,
                         seed: int = 42
                         ) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                    Tuple[np.ndarray, np.ndarray]]:
    """Deterministic MNIST-like data: per-class blob patterns + noise."""
    rng = np.random.RandomState(seed)
    patterns = rng.randn(10, 28 * 28).astype(np.float32)

    def make_split(n, split_seed):
        r = np.random.RandomState(split_seed)
        labels = r.randint(0, 10, n)
        images = (patterns[labels]
                  + 0.5 * r.randn(n, 28 * 28).astype(np.float32))
        return images.astype(np.float32), labels.astype(np.int32)

    return make_split(num_train, seed + 1), make_split(num_val, seed + 2)


class MLPMNISTDataLoader:
    """Shuffled batches of a static size; the last batch is padded with
    copies of its first row, weighted 0. Under a data-parallel `mesh`
    each rank gets its rows of every (global) batch."""

    def __init__(self, images, labels, batch_size: int, *,
                 shuffle: bool, seed: int = 0,
                 mesh: Optional[pmesh.Mesh] = None) -> None:
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.rows = pmesh.batch_rows(mesh, batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return (len(self.images) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.images)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            pad = self.batch_size - len(idx)
            images = self.images[idx]
            labels = self.labels[idx]
            weights = np.ones(len(idx), np.float32)
            if pad:
                images = np.concatenate([images, images[:1].repeat(pad, 0)])
                labels = np.concatenate([labels, labels[:1].repeat(pad)])
                weights = np.concatenate([weights, np.zeros(pad,
                                                            np.float32)])
            yield {"images": images[self.rows], "labels": labels[self.rows],
                   "weights": weights[self.rows]}


def split_all(batch: Dict[str, np.ndarray]):
    """(arrays to ship, host part) of an MLP batch for `prefetch`: every
    array is shipped."""
    return batch, {}


# ---------- config ----------

class MLPMNISTExperimentConfig(trainer_configs.BaseExperimentConfig):
    """(reference mlp_mnist.py MLPMNISTExperimentConfig)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__(config)
        self.name = "config_mlp"
        self.train = self.pop_group("train",
                                    trainer_configs.BaseTrainConfig)
        self.val = self.pop_group("val", trainer_configs.BaseValConfig)
        self.dataset_train = self.pop_group(
            "dataset_train", trainer_configs.BaseDatasetConfig)
        self.dataset_val = self.pop_group(
            "dataset_val", trainer_configs.BaseDatasetConfig)
        self.logging = self.pop_group(
            "logging", trainer_configs.BaseLoggingConfig)
        self.saving = self.pop_group(
            "saving", trainer_configs.BaseSavingConfig)
        self.optimizer = self.pop_group(
            "optimizer", trainer_configs.OptimizerConfig)
        self.lr_scheduler = self.pop_group(
            "lr_scheduler", trainer_configs.SchedulerConfig)
        self.mlp_hidden_dim: int = self.config.pop("mlp_hidden_dim", 128)
        self.post_init()


# ---------- model ----------

class MLPModel(nn.Module):
    """Linear -> ReLU -> Linear (JAX `MLPModel`: Dense_0, Dense_1)."""

    def __init__(self, hidden_dim: int = 128) -> None:
        super().__init__()
        self.fc1 = nn.Linear(28 * 28, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 10)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(images)))


class MLPModelManager:
    """The model on its device, initialised from a seed."""

    def __init__(self, cfg: MLPMNISTExperimentConfig,
                 device: torch.device, seed: int = 0) -> None:
        self.cfg = cfg
        self.device = device
        torch.manual_seed(seed)
        self.model = MLPModel(hidden_dim=cfg.mlp_hidden_dim).to(device)
        self.was_loaded = False

    def count_parameters(self) -> int:
        return sum(p.numel() for p in self.model.parameters())


def nll_per_row(logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def mlp_train_step(model: MLPModel, optimizer: Adam,
                   batch: Dict[str, torch.Tensor], lr: float,
                   mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
    """Weighted mean NLL over the global batch, its gradients (summed over
    the ranks of `mesh`) and one Adam update; returns the loss."""
    params = dict(model.named_parameters())
    nll = nll_per_row(model(batch["images"]), batch["labels"])
    w = batch["weights"]
    total_w = pmesh.all_reduce_sum(mesh, w.sum())
    loss = (nll * w).sum() / total_w.clamp(min=1.0)
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.step(pmesh.all_reduce_grads(mesh, dict(zip(params, grads))),
                   lr)
    return pmesh.all_reduce_sum(mesh, loss.detach())


# ---------- trainer ----------

class MLPMNISTTrainer(BaseTrainer):
    """(reference MLPMNISTTrainer)."""

    def __init__(self, cfg: MLPMNISTExperimentConfig,
                 model_mgr: MLPModelManager, exp_group: str,
                 exp_name: str, run_name: str, train_loader_length: int,
                 *, log_dir: str = TrainerPathConst.DIR_EXPERIMENTS,
                 load_model=None, load_best: bool = False,
                 load_epoch=None, reset: bool = False,
                 is_test: bool = False,
                 mesh: Optional[pmesh.Mesh] = None) -> None:
        super().__init__(cfg, model_mgr, exp_group, exp_name, run_name,
                         train_loader_length, EXP_TYPE,
                         load_model=load_model, load_best=load_best,
                         load_epoch=load_epoch, reset=reset,
                         is_test=is_test, log_dir=log_dir, mesh=mesh)
        self.model = model_mgr.model
        self.optimizer = Adam(dict(self.model.named_parameters()), 0.9,
                              cfg.optimizer.adam_beta2,
                              cfg.optimizer.adam_eps,
                              cfg.optimizer.weight_decay,
                              cfg.optimizer.weight_decay_for_bias)
        self.lr_scheduler = make_lr_scheduler(
            cfg.lr_scheduler, cfg.optimizer.lr, cfg.train.num_epochs,
            train_loader_length, self.logger)
        self.hook_post_init()
        pmesh.broadcast_params(self.mesh, self.model.parameters())

    # ---------- state ----------

    def get_model_state(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def set_model_state(self, state) -> None:
        self.model.load_state_dict(state)
        self.model_mgr.was_loaded = True

    def get_opt_state(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict()}

    def set_opt_state(self, state) -> None:
        self.optimizer.load_state_dict(state["optimizer"])

    # ---------- steps ----------

    def train_step(self, batch: Dict[str, torch.Tensor], lr: float
                   ) -> torch.Tensor:
        return mlp_train_step(self.model, self.optimizer, batch, lr,
                              self.mesh)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        logits = self.model(batch["images"])
        w = batch["weights"]
        correct = ((logits.argmax(-1) == batch["labels"].long()).float()
                   * w).sum()
        nll = nll_per_row(logits, batch["labels"])
        return pmesh.all_reduce_metrics(self.mesh, {
            "correct": correct, "count": w.sum(),
            "loss_sum": (nll * w).sum()})

    # ---------- loops ----------

    def train_model(self, train_loader, val_loader) -> None:
        self.hook_pre_train()
        for _epoch in range(self.state.current_epoch,
                            self.cfg.train.num_epochs):
            if self.check_early_stop():
                break
            train_loader.set_epoch(self.state.current_epoch)
            self.hook_pre_train_epoch()
            for step, (batch, _) in enumerate(prefetch(
                    train_loader, self.device, split=split_all)):
                self.hook_pre_step_timer()
                lr = self.lr_scheduler.current_lr
                loss = float(self.train_step(batch, lr))
                self.hook_post_forward_step_timer()
                self.hook_post_step(step, loss, lr)
            is_val = self.check_is_val_epoch()
            has_improved = False
            if is_val:
                _loss, _acc, has_improved = self.validate_epoch(
                    val_loader)
            self.hook_post_train_and_val_epoch(is_val, has_improved)
        self.hook_post_train()

    def validate_epoch(self, val_loader) -> Tuple[float, float, bool]:
        self.hook_pre_val_epoch()
        sums = {"correct": 0.0, "count": 0.0, "loss_sum": 0.0}
        for batch, _ in prefetch(val_loader, self.device,
                                 split=split_all):
            out = self.eval_step(batch)
            values = torch.stack([out[k] for k in sums]).tolist()
            for name, value in zip(sums, values):
                sums[name] += value
        accuracy = sums["correct"] / max(sums["count"], 1)
        val_loss = sums["loss_sum"] / max(sums["count"], 1)
        self.logger.info(f"Validation loss {val_loss:.5f} "
                         f"acc {accuracy:.3%}")
        is_best = self.check_is_new_best(accuracy)
        self.hook_post_val_epoch(val_loss, is_best)
        return val_loss, accuracy, is_best
