"""
Optimizers of the retrieval task: RAdam (every retrieval config) and Adam,
plus the global gradient norm and clipping.

Port of coot_videotext_tpu/train/optim.py (`_decay_mask` :51, `make_radam`
:66, `make_adam` :120, `make_optimizer` :156, `global_norm` :281,
`clip_by_global_norm` :287). The state is float32 and keyed like the
model's state dict (`net_video_local.input_fc.mlp.0.weight`, ...); the
update is applied IN PLACE to the parameters and to the moment buffers
(JAX returns new trees), which keeps one copy of each in device memory.
The step-dependent scalars are computed in float32, as in the JAX step.

Numerical parity (reference nntrainer/optimization.py:79-183): RAdam's
rectification N_sma with the >= 5 threshold, the step size including
1/(1-beta1^t), denom sqrt(v) + eps, decoupled weight decay
p -= wd * lr * p applied only when an update happens, the optional
degenerate-to-SGD branch. The decay rule of model_manager_base.py:146-153:
with `weight_decay_for_bias` true, parameters whose name contains 'bias'
get no decay (the reference flag reads inverted; reproduced).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.config.base import (
    OptimizerConfig, OptimizerConst)

Params = Dict[str, torch.Tensor]


def decay_mults(names: Iterable[str], weight_decay_for_bias: bool
                ) -> Dict[str, float]:
    """Per-parameter decay multiplier (JAX `_decay_mask` :51, by name)."""
    return {n: 0.0 if (weight_decay_for_bias and "bias" in n) else 1.0
            for n in names}


class _MomentOptimizer:
    """Shared state of RAdam and Adam: step count, first and second
    moments (float32, keyed by parameter name)."""

    def __init__(self, params: Params, weight_decay: float,
                 weight_decay_for_bias: bool) -> None:
        self.params = dict(params)
        self.weight_decay = weight_decay
        self.decay = decay_mults(self.params, weight_decay_for_bias)
        self.step_count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}

    def state_dict(self) -> Dict[str, object]:
        return {"step": self.step_count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if set(state["mu"]) != set(self.params):
            raise ValueError("optimizer state does not match the model's "
                             "parameters")
        self.step_count = int(state["step"])
        for n in self.params:
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])

    def _moments(self, name: str, g: torch.Tensor, beta1: float,
                 beta2: float) -> Tuple[torch.Tensor, torch.Tensor]:
        m, v = self.mu[name], self.nu[name]
        m.mul_(beta1).add_(g, alpha=1.0 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
        return m, v


class RAdam(_MomentOptimizer):
    """RAdam (JAX make_radam :66, reference optimization.py:79)."""

    def __init__(self, params: Params, beta1: float, beta2: float,
                 eps: float, weight_decay: float,
                 degenerated_to_sgd: bool = False,
                 weight_decay_for_bias: bool = True) -> None:
        super().__init__(params, weight_decay, weight_decay_for_bias)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.degenerated_to_sgd = degenerated_to_sgd

    @torch.no_grad()
    def step(self, grads: Params, lr: float) -> None:
        self.step_count += 1
        f32 = np.float32
        t = f32(self.step_count)
        beta1, beta2 = f32(self.beta1), f32(self.beta2)
        beta2_t = beta2 ** t
        n_sma_max = f32(2.0) / (f32(1.0) - beta2) - f32(1.0)
        n_sma = n_sma_max - f32(2.0) * t * beta2_t / (f32(1.0) - beta2_t)
        bias1 = f32(1.0) - beta1 ** t
        use_adam = bool(n_sma >= 5.0)
        if not use_adam and not self.degenerated_to_sgd:
            for name in self.params:
                self._moments(name, grads[name].float(), self.beta1,
                              self.beta2)
            return
        if use_adam:
            rect = np.sqrt((f32(1.0) - beta2_t) * (n_sma - f32(4.0))
                           / (n_sma_max - f32(4.0)) * (n_sma - f32(2.0))
                           / n_sma * n_sma_max / (n_sma_max - f32(2.0)))
            step_size = float(f32(rect) / bias1)
        else:
            step_size = float(f32(1.0) / bias1)
        for name, p in self.params.items():
            m, v = self._moments(name, grads[name].float(), self.beta1,
                                 self.beta2)
            wd = self.weight_decay * self.decay[name] * lr
            if use_adam:
                delta = (step_size * lr) * m / (v.sqrt() + self.eps)
            else:
                delta = (step_size * lr) * m
            if wd:
                delta = delta + wd * p
            p.sub_(delta.to(p.dtype))


class Adam(_MomentOptimizer):
    """Adam with bias correction and L2 (torch-style) decay (JAX make_adam
    :120)."""

    def __init__(self, params: Params, beta1: float, beta2: float,
                 eps: float, weight_decay: float,
                 weight_decay_for_bias: bool = True) -> None:
        super().__init__(params, weight_decay, weight_decay_for_bias)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps

    @torch.no_grad()
    def step(self, grads: Params, lr: float) -> None:
        self.step_count += 1
        f32 = np.float32
        t = f32(self.step_count)
        bias1 = float(f32(1.0) - f32(self.beta1) ** t)
        bias2 = float(f32(1.0) - f32(self.beta2) ** t)
        for name, p in self.params.items():
            g = grads[name].float()
            wd = self.weight_decay * self.decay[name]
            if wd:
                g = g + wd * p.float()
            m, v = self._moments(name, g, self.beta1, self.beta2)
            p.sub_((lr * (m / bias1) / ((v / bias2).sqrt() + self.eps)
                    ).to(p.dtype))


def make_optimizer(cfg: OptimizerConfig, params: Params):
    """Optimizer factory (JAX :156, reference optimization.py:45)."""
    if cfg.name == OptimizerConst.RADAM:
        return RAdam(params, cfg.momentum, cfg.adam_beta2, cfg.adam_eps,
                     cfg.weight_decay, cfg.radam_degentosgd,
                     cfg.weight_decay_for_bias)
    if cfg.name == OptimizerConst.ADAM:
        return Adam(params, cfg.momentum, cfg.adam_beta2, cfg.adam_eps,
                    cfg.weight_decay, cfg.weight_decay_for_bias)
    raise NotImplementedError(f"Unknown optimizer {cfg.name}")


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, float32."""
    total = sum((g.float() * g.float()).sum() for g in grads.values())
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float) -> torch.Tensor:
    """torch clip_grad_norm_ parity, in place; returns the pre-clip
    norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return norm
