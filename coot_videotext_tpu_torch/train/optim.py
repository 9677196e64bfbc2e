"""
Optimizers: RAdam (every retrieval config) and Adam, BertAdam with its
warmup_linear schedule (every MART config) and the EMA shadow, plus the
global gradient norm and clipping.

Port of coot_videotext_tpu/train/optim.py (`_decay_mask` :51, `make_radam`
:66, `make_adam` :120, `make_optimizer` :156, `make_bertadam` :176,
`warmup_linear` :242, `ema_init` :258, `ema_update` :268, `global_norm`
:281, `clip_by_global_norm` :287). The state is float32 and keyed like the
model's state dict (`net_video_local.input_fc.mlp.0.weight`, ...); the
update is applied IN PLACE to the parameters and to the moment buffers
(JAX returns new trees), which keeps one copy of each in device memory.

Everything a step reads lives on the parameters' device: the step count
(int32, as JAX's), the learning rate (a float32 scalar that `step` or the
trainer fills) and the step-dependent scalars, computed there in float32
with `torch.where` for RAdam's branch (JAX :96-111). The update runs as
`torch._foreach_*` ops over all tensors at once. No step reads a value
back to the host, so a train step that ends in `step` can be captured
into a CUDA graph and replayed.

Numerical parity (reference nntrainer/optimization.py:79-183): RAdam's
rectification N_sma with the >= 5 threshold, the step size including
1/(1-beta1^t), denom sqrt(v) + eps, decoupled weight decay
p -= wd * lr * p applied only when an update happens, the optional
degenerate-to-SGD branch. The decay rule of model_manager_base.py:146-153:
with `weight_decay_for_bias` true, parameters whose name contains 'bias'
get no decay (the reference flag reads inverted; reproduced).

BertAdam (reference mart/optimization.py:250) has no bias correction,
clips each gradient by its own norm inside the step and adds the decay to
the update; its decay and freeze masks follow JAX's rule on the names JAX
gives the parameters (a path containing `bias`, `scale` or `gain` is not
decayed, one containing a frozen name is not moved), so each parameter is
passed with its JAX path (utils/param_bridge.py `mart_jax_paths`). The
learning rate comes from the host's `warmup_linear` schedule, computed in
float32 as JAX does. The EMA shadow is a float32 copy that never aliases a
parameter; its ramp reads the train state's step on the device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

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
    """Shared state of RAdam, Adam and BertAdam: step count and learning
    rate (device scalars), first and second moments (float32, keyed by
    parameter name); `decay` is each parameter's decay multiplier."""

    def __init__(self, params: Params, weight_decay: float,
                 decay: Dict[str, float]) -> None:
        self.params = dict(params)
        self.weight_decay = weight_decay
        self.decay = decay
        device = next(iter(self.params.values())).device
        self.step_count = torch.zeros((), dtype=torch.int32, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}
        self._names = list(self.params)
        self._decayed = [i for i, n in enumerate(self._names)
                         if weight_decay and self.decay[n]]

    def state_dict(self) -> Dict[str, object]:
        return {"step": self.step_count.clone(), "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """In place, so that the tensors a captured step reads stay where
        they are; `step` may be an int (files of earlier versions) or a
        tensor."""
        if set(state["mu"]) != set(self.params):
            raise ValueError("optimizer state does not match the model's "
                             "parameters")
        self.step_count.copy_(torch.as_tensor(state["step"]))
        for n in self.params:
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])

    def _lists(self, grads: Params):
        """(params, mu, nu, float32 grads) as lists in one order."""
        return ([self.params[n] for n in self._names],
                [self.mu[n] for n in self._names],
                [self.nu[n] for n in self._names],
                [grads[n].float() for n in self._names])

    def _pick(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        return [tensors[i] for i in self._decayed]

    def _begin(self, lr: Optional[float]) -> torch.Tensor:
        """Sets the learning rate (None: keep the one filled in) and counts
        the step; returns t as float32."""
        if lr is not None:
            self.lr.fill_(lr)
        self.step_count.add_(1)
        return self.step_count.float()

    @staticmethod
    def _moments(m, v, g, beta1: float, beta2: float) -> None:
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, g, alpha=1.0 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - beta2)


class RAdam(_MomentOptimizer):
    """RAdam (JAX make_radam :66, reference optimization.py:79)."""

    def __init__(self, params: Params, beta1: float, beta2: float,
                 eps: float, weight_decay: float,
                 degenerated_to_sgd: bool = False,
                 weight_decay_for_bias: bool = True) -> None:
        super().__init__(params, weight_decay,
                         decay_mults(params, weight_decay_for_bias))
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.degenerated_to_sgd = degenerated_to_sgd

    @torch.no_grad()
    def step(self, grads: Params, lr: Optional[float] = None) -> None:
        """One update with `lr` (None: the learning rate filled in)."""
        t = self._begin(lr)
        p, m, v, g = self._lists(grads)
        self._moments(m, v, g, self.beta1, self.beta2)
        beta2_t = torch.pow(self.beta2, t)
        n_sma_max = 2.0 / (1.0 - self.beta2) - 1.0
        n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
        bias1 = 1.0 - torch.pow(self.beta1, t)
        use_adam = n_sma >= 5.0
        rect = torch.sqrt(
            (1.0 - beta2_t) * (n_sma - 4.0) / (n_sma_max - 4.0)
            * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0))
        # rect is nan for n_sma <= 4 but is only taken when >= 5
        step_size = torch.where(use_adam, rect, 0.0) / bias1
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        if self.degenerated_to_sgd:
            # SGD below the threshold: divide by 1 instead of the denom
            on = use_adam.float()
            torch._foreach_mul_(denom, on)
            torch._foreach_add_(denom, 1.0 - on)
            step_size = torch.where(use_adam, step_size, 1.0 / bias1)
            update = torch.ones_like(use_adam)
        else:  # no update at all below the threshold
            update = use_adam
        delta = torch._foreach_div(m, denom)
        torch._foreach_mul_(delta, step_size * self.lr)
        if self._decayed:
            wd_lr = torch.where(update, self.weight_decay * self.lr, 0.0)
            torch._foreach_add_(self._pick(delta),
                                torch._foreach_mul(self._pick(p), wd_lr))
        torch._foreach_sub_(p, delta)


class Adam(_MomentOptimizer):
    """Adam with bias correction and L2 (torch-style) decay (JAX make_adam
    :120)."""

    def __init__(self, params: Params, beta1: float, beta2: float,
                 eps: float, weight_decay: float,
                 weight_decay_for_bias: bool = True) -> None:
        super().__init__(params, weight_decay,
                         decay_mults(params, weight_decay_for_bias))
        self.beta1, self.beta2, self.eps = beta1, beta2, eps

    @torch.no_grad()
    def step(self, grads: Params, lr: Optional[float] = None) -> None:
        """One update with `lr` (None: the learning rate filled in)."""
        t = self._begin(lr)
        p, m, v, g = self._lists(grads)
        if self._decayed:  # torch Adam couples the decay into the gradient
            g = list(g)
            decayed = torch._foreach_add(self._pick(g), self._pick(p),
                                         alpha=self.weight_decay)
            for i, gi in zip(self._decayed, decayed):
                g[i] = gi
        self._moments(m, v, g, self.beta1, self.beta2)
        bias1 = 1.0 - torch.pow(self.beta1, t)
        bias2 = 1.0 - torch.pow(self.beta2, t)
        denom = torch._foreach_div(v, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        delta = torch._foreach_div(m, bias1)
        torch._foreach_mul_(delta, self.lr)
        torch._foreach_div_(delta, denom)
        torch._foreach_sub_(p, delta)


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


# ---------- BertAdam (MART) ----------

NO_DECAY_NAMES = ("bias", "scale", "gain")


def name_mults(paths: Dict[str, str], names: Iterable[str]
               ) -> Dict[str, float]:
    """0 for each parameter whose path contains one of `names`, else 1
    (JAX `_name_mask` :202)."""
    names = tuple(names)
    return {n: 0.0 if any(k in path for k in names) else 1.0
            for n, path in paths.items()}


class BertAdam(_MomentOptimizer):
    """BertAdam as every MART config runs it (JAX make_bertadam :176 with
    the MART trainer's arguments, trainer.py:112-116): betas 0.9 / 0.999,
    no bias correction, each gradient clipped to norm 1 by its own norm
    (+ 1e-6), update = m / (sqrt(v) + eps) + 0.01 * decay * p, then p -=
    lr * update where not frozen. `paths` maps each parameter name to the
    path the masks read (its JAX path): NO_DECAY_NAMES exempt from the
    decay, `frozen_names` from the update; a frozen parameter's moments
    still move."""

    BETA1, BETA2, WEIGHT_DECAY, MAX_GRAD_NORM = 0.9, 0.999, 0.01, 1.0

    def __init__(self, params: Params, paths: Dict[str, str], *,
                 eps: float, frozen_names: Iterable[str] = ()) -> None:
        if set(paths) != set(params):
            raise ValueError("BertAdam needs a path for every parameter")
        super().__init__(params, self.WEIGHT_DECAY,
                         name_mults(paths, NO_DECAY_NAMES))
        self.eps = eps
        self.frozen = {n for n, m in name_mults(
            paths, frozen_names).items() if not m}
        self._moved = [i for i, n in enumerate(self._names)
                       if n not in self.frozen]

    @torch.no_grad()
    def step(self, grads: Params, lr: Optional[float] = None,
             tp=None) -> None:
        """One update with `lr` (None: the learning rate filled in); the
        gradients are not changed. Under tensor parallelism (`tp`: the
        parallel/tp.py `Layout` of the sharded parameters) a sharded
        tensor's norm spans the model group."""
        self._begin(lr)
        p, m, v, g = self._lists(grads)
        norms = torch.stack(torch._foreach_norm(g))  # JAX :217-223
        if tp is not None:
            norms = tensor_norms(tp, self._names, norms)
        scales = torch.clamp(self.MAX_GRAD_NORM / (norms + 1e-6), max=1.0)
        g = torch._foreach_mul(g, list(scales.unbind()))
        self._moments(m, v, g, self.BETA1, self.BETA2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m, denom)
        torch._foreach_add_(self._pick(update), self._pick(p),
                            alpha=self.weight_decay)
        moved = [update[i] for i in self._moved]
        torch._foreach_mul_(moved, self.lr)
        torch._foreach_sub_([p[i] for i in self._moved], moved)


def warmup_linear(progress: float, warmup: float) -> float:
    """The BertAdam schedule factor (JAX :242, reference
    mart/optimization.py:100-130): a ramp 0 -> 1 over the `warmup`
    fraction, then max((progress - 1) / (warmup - 1), 0), in float32."""
    f32 = np.float32
    p, w = f32(progress), f32(warmup)
    if p < w:
        return float(p / max(w, f32(1e-9)))
    return float(max((p - f32(1.0)) / (w - f32(1.0)), f32(0.0)))


class EMA:
    """The EMA shadow (JAX ema_init :258, ema_update :268): a float32
    copy of every parameter, shadow = (1 - d) * p + d * shadow with
    d = min(decay, (1 + t) / (10 + t)), t the train state's step before
    the step's increment. `aliases` ({key: parameter name}, a tied
    parameter's second state-dict key) are written by state_dict, so it
    is the model's full state dict, and skipped by load_state_dict."""

    def __init__(self, params: Params, decay: float,
                 aliases: Optional[Dict[str, str]] = None) -> None:
        self.params = dict(params)
        self.decay = decay
        self.aliases = dict(aliases or {})
        self.shadow = {n: p.detach().float().clone()
                       for n, p in self.params.items()}
        self._names = list(self.params)

    @torch.no_grad()
    def update(self, step: torch.Tensor) -> None:
        t = step.float()
        d = torch.clamp((1.0 + t) / (10.0 + t), max=self.decay)
        shadow = [self.shadow[n] for n in self._names]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, torch._foreach_mul(
            [self.params[n].float() for n in self._names], 1.0 - d))

    @torch.no_grad()
    def reset(self) -> None:
        """The shadow := the parameters."""
        for n in self._names:
            self.shadow[n].copy_(self.params[n])

    def state_dict(self) -> Dict[str, torch.Tensor]:
        out = {n: s.detach().cpu() for n, s in self.shadow.items()}
        out.update({a: out[n] for a, n in self.aliases.items()})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        state = {k: v for k, v in state.items() if k not in self.aliases}
        if set(state) != set(self.shadow):
            raise ValueError("EMA state does not match the model's "
                             "parameters")
        for n, s in self.shadow.items():
            s.copy_(state[n])


def tensor_norms(tp, names: List[str], norms: torch.Tensor) -> torch.Tensor:
    """Each tensor's norm with a sharded tensor's squares summed over the
    model group (`tp`: parallel/tp.py `Layout`; one that shards nothing
    leaves them as they are)."""
    if not tp.shards:
        return norms
    sharded = tp.sharded_mask(names, norms.device)
    sq = tp.sum_over_model(torch.where(sharded, norms * norms, 0.0))
    return torch.where(sharded, torch.sqrt(sq), norms)


def global_norm(grads: Params, tp=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, float32: the norm of
    the per-tensor norms, as torch's clip_grad_norm_ takes it. Under
    tensor parallelism (`tp`: parallel/tp.py `Layout`) a sharded
    gradient's squares are summed over the model group, a replicated one's
    counted once."""
    norms = torch.stack(torch._foreach_norm([g.float()
                                             for g in grads.values()]))
    if tp is not None:
        norms = tensor_norms(tp, list(grads), norms)
    return torch.linalg.vector_norm(norms)


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float,
                        tp=None) -> torch.Tensor:
    """torch clip_grad_norm_ parity, in place and without a host sync;
    returns the pre-clip norm (`tp`: as global_norm)."""
    norm = global_norm(grads, tp)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(list(grads.values()), scale)
    return norm
