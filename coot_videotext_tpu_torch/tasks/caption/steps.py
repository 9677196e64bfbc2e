"""
The caption train and eval steps (MART, recurrent).

Port of coot_videotext_tpu/tasks/caption/steps.py (`make_caption_train_step`
:45, `make_caption_eval_step` :103; reference mart/trainer_caption.py
:253-350, ~420).

The train step runs, in order: the model in training mode, the S-step
teacher-forced forward with dropout (kernel B4 at every site on the card)
inside `ops/philox.dropout_seeds` of the state's seed state, the caption
loss (a sum over tokens), the token-accuracy counts of that forward, the
backward through autograd, clipping by the global norm (whose pre-clip
value is `grad_norm`), the BertAdam update at the host's lr, the EMA
update with the state's step before its increment, then step + 1 and seed
state + 1. The eval step runs the same forward in eval mode under
torch.inference_mode(). Both return device tensors that the caller reads
once per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from coot_videotext_tpu_torch.models.caption.mart import (
    RecursiveTransformer)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.ops.philox import dropout_seeds
from coot_videotext_tpu_torch.train.loss_caption import token_accuracy_counts
from coot_videotext_tpu_torch.train.optim import (
    EMA, BertAdam, clip_by_global_norm)
from coot_videotext_tpu_torch.utils.param_bridge import mart_jax_paths

# the global-norm clip of the train step, fixed by the JAX trainer
# (trainer.py:148-150), not read from cfg.train.clip_gradient
CLIP_GRADIENT = 1.0


@dataclasses.dataclass
class CaptionTrainState:
    """The model (float32 parameters), BertAdam (its moments keyed like the
    state dict, its step count and lr on the device), the EMA shadow (None
    without one), the seed state (a (1,) int64 tensor, ops/philox.py
    `seed_state`) and the step (an int32 scalar), both on the model's
    device (JAX CaptionTrainState :33)."""
    model: RecursiveTransformer
    optimizer: BertAdam
    ema: Optional[EMA]
    seed: torch.Tensor
    step: torch.Tensor


def init_caption_train_state(model: RecursiveTransformer, cfg, seed: int
                             ) -> CaptionTrainState:
    """The train state of `model` on its device (JAX
    init_caption_train_state :140 and MartTrainer :108-116): BertAdam with
    eps = cfg.eps, its masks on the parameters' JAX paths, the word
    embeddings frozen under use_glove + freeze_glove; the EMA when
    cfg.ema_decay > 0; the seed state of `seed`; step 0."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    frozen = (("word_embeddings",) if cfg.use_glove and cfg.freeze_glove
              else ())
    return CaptionTrainState(
        model=model,
        optimizer=BertAdam(params, mart_jax_paths(model), eps=cfg.eps,
                           frozen_names=frozen),
        ema=EMA(params, cfg.ema_decay) if cfg.ema_decay > 0 else None,
        seed=philox.seed_state(seed, device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _forward(model: RecursiveTransformer, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, n_correct, n_word) of the S-step forward in the model's
    mode."""
    loss, scores_list = model(
        batch["input_ids"], batch["video_feature"], batch["input_mask"],
        batch["token_type_ids"], batch["input_labels"])
    n_correct = loss.new_zeros(())
    n_word = loss.new_zeros(())
    with torch.no_grad():
        for idx, scores in enumerate(scores_list):
            c, w = token_accuracy_counts(scores, batch["input_labels"][idx])
            n_correct = n_correct + c
            n_word = n_word + w
    return loss, n_correct, n_word


def caption_loss_and_grads(state: CaptionTrainState,
                           batch: Dict[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor]]:
    """The training forward (dropout on, seeded by the state) and its
    backward: ({loss, n_correct, n_word} detached, the float32 gradient of
    every parameter by name; zeros where the loss does not reach, as under
    jax.grad)."""
    model = state.model
    model.train()
    params = state.optimizer.params
    with dropout_seeds(state.seed):
        loss, n_correct, n_word = _forward(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return {"loss": loss.detach(), "n_correct": n_correct,
            "n_word": n_word}, grads


def caption_update(state: CaptionTrainState,
                   grads: Dict[str, torch.Tensor], lr: float
                   ) -> torch.Tensor:
    """The step after the backward: clipping by the global norm to
    CLIP_GRADIENT (the gradients in place), BertAdam at `lr`, the EMA with
    the step before its increment, then step + 1 and seed state + 1.
    Returns the pre-clip norm."""
    norm = clip_by_global_norm(grads, CLIP_GRADIENT)
    state.optimizer.step(grads, lr)
    if state.ema is not None:
        state.ema.update(state.step)
    state.step.add_(1)
    state.seed.add_(1)
    return norm


def caption_train_step(state: CaptionTrainState,
                       batch: Dict[str, torch.Tensor], lr: float
                       ) -> Dict[str, torch.Tensor]:
    """One train step on a stacked (S, N, ...) batch on the model's device;
    returns {loss (sum over steps), n_correct, n_word, grad_norm} as 0-d
    float32 device tensors. The parameters, the optimizer, the EMA, the
    step and the seed state are updated in place."""
    metrics, grads = caption_loss_and_grads(state, batch)
    metrics["grad_norm"] = caption_update(state, grads, lr)
    return metrics


def caption_eval_step(model: RecursiveTransformer,
                      batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """{loss (sum over steps), n_correct, n_word} of one stacked batch,
    as 0-d f32 tensors on the batch's device."""
    model.eval()
    with torch.inference_mode():
        loss, n_correct, n_word = _forward(model, batch)
    return {"loss": loss, "n_correct": n_correct, "n_word": n_word}
