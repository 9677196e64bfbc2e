"""
Retrieval train and eval steps (port of coot_videotext_tpu/tasks/retrieval/
steps.py: `make_retrieval_train_step` :41 in its dense per-step form, and
`make_retrieval_eval_step` :144-209).

The train step runs the 4-net forward in the compute dtype with dropout on
(every dropout draws its seed from the state's CPU generator), the total
loss (cycle-consistency subsampling from the state's device generator),
the backward through autograd and the kernels' backward, the optional
global-norm clipping and the optimizer update in place. The eval step runs
the forward in eval mode and returns the val loss parts and the raw and
L2-normalized embeddings, all on the batch's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from coot_videotext_tpu_torch.models.retrieval import RetrievalModel
from coot_videotext_tpu_torch.ops.philox import dropout_seeds
from coot_videotext_tpu_torch.train.losses import (
    compute_total_retrieval_loss, l2_normalize)
from coot_videotext_tpu_torch.train.optim import clip_by_global_norm

VISUAL_KEYS = ("vid_emb", "clip_emb", "vid_context", "clip_valid",
               "clip_num")
TEXT_KEYS = ("par_emb", "sent_emb", "par_context", "sent_valid", "sent_num")
EMB_KEYS = ("vid_emb", "par_emb", "clip_emb", "sent_emb", "vid_context",
            "par_context")


@dataclasses.dataclass
class TrainState:
    """The model (float32 parameters), its optimizer (float32 state, keyed
    like the state dict), the step count and the run's two generators:
    `seeds` (CPU) draws the dropout seeds, `cc` (on the model's device)
    the cycle-consistency subsampling (JAX TrainState :34 and the rng
    split of :78)."""
    model: RetrievalModel
    optimizer: object
    seeds: Optional[torch.Generator]
    cc: Optional[torch.Generator]
    step: int = 0


def _loss_inputs(out: Dict[str, torch.Tensor]):
    return ({k: out[k] for k in VISUAL_KEYS}, {k: out[k] for k in TEXT_KEYS})


def retrieval_loss_and_grads(
        state: TrainState, batch: Dict[str, torch.Tensor], *,
        loss_weights: Dict[str, float], margin: float,
        loss_cycle_cons: float,
        compute_dtype: torch.dtype = torch.float32
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The training forward (dropout on) and backward: (detached loss
    parts, float32 gradient of every parameter by name). A parameter that
    the loss does not reach gets a zero gradient, as under jax.grad."""
    model = state.model
    model.train()
    params = state.optimizer.params
    with dropout_seeds(state.seeds):
        out = model(batch, compute_dtype=compute_dtype)
    visual, text = _loss_inputs(out)
    loss, parts = compute_total_retrieval_loss(
        visual, text, loss_weights, margin, loss_cycle_cons,
        generator=state.cc, batch_valid=batch["batch_valid"])
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return {k: v.detach() for k, v in parts.items()}, grads


def retrieval_train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                         *, lr: float, loss_weights: Dict[str, float],
                         margin: float, loss_cycle_cons: float,
                         clip_gradient: float = -1.0,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """One training step; returns the detached loss parts (and
    `grad_norm` with clipping, as the reference computes the norm only
    then, trainer_base.py:545-554). The parameters and the optimizer
    state are updated in place."""
    metrics, grads = retrieval_loss_and_grads(
        state, batch, loss_weights=loss_weights, margin=margin,
        loss_cycle_cons=loss_cycle_cons, compute_dtype=compute_dtype)
    if clip_gradient > 0:
        metrics["grad_norm"] = clip_by_global_norm(grads, clip_gradient)
    state.optimizer.step(grads, lr)
    state.step += 1
    return metrics


@torch.inference_mode()
def retrieval_eval_step(model: RetrievalModel,
                        batch: Dict[str, torch.Tensor], *,
                        loss_weights: Dict[str, float], margin: float,
                        loss_cycle_cons: float,
                        compute_dtype: torch.dtype = torch.float32,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Returns (embeddings, loss parts). `generator` drives the
    cycle-consistency subsampling; None takes its deterministic full
    mean."""
    model.eval()
    out = model(batch, compute_dtype=compute_dtype)
    visual, text = _loss_inputs(out)
    _, parts = compute_total_retrieval_loss(
        visual, text, loss_weights, margin, loss_cycle_cons,
        generator=generator, batch_valid=batch["batch_valid"])
    embs = {f"{k}_before_norm": out[k] for k in EMB_KEYS}
    embs.update({k: l2_normalize(out[k]) for k in EMB_KEYS})
    for k in ("clip_valid", "sent_valid", "clip_num", "sent_num"):
        embs[k] = out[k]
    return embs, parts
