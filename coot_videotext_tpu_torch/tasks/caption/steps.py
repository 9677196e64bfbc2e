"""
The caption train and eval steps: the recurrent models (MART and the
TransformerXL, stacked batches) and the single-sentence models (the
untied layout of NonRecurTransformerUntied and the MTransformer, the
joint layout of NonRecurTransformer).

Port of coot_videotext_tpu/tasks/caption/steps.py (`make_caption_train_step`
:45, `make_caption_eval_step` :103, `_single_forward` :152,
`make_caption_train_step_single` :167, `make_caption_eval_step_single`
:209; reference mart/trainer_caption.py :253-350, ~420).

The train step runs, in order: the model in training mode, the
teacher-forced forward (S sentence steps, or one sentence) with
dropout (kernel B4 at every site on the card) inside
`ops/philox.dropout_seeds` of the state's seed state, the caption loss (a
sum over tokens), the token-accuracy counts of that forward, the
backward through autograd, clipping by the global norm (whose pre-clip
value is `grad_norm`), the BertAdam update at the host's lr, the EMA
update with the state's step before its increment, then step + 1 and seed
state + 1. It runs as a program of the train state's graph cache
(utils/graphs.py, `train_programs`: a CUDA graph on the card, one per
batch shape, as JAX jits one, :45, :167): the host's lr goes into
BertAdam's device lr before each call and the body reads it there; the
first call of a shape is the capture's eager run, which is the step, and
every later call one replay, so n calls are n steps. The programs read
the parameters, BertAdam's moments, step count and lr, the EMA shadow, the
seed state and the step, and are dropped when one of them moves
(`load_state_dict` and the EMA swap copy in place and keep them).
`eager=True` runs the step op by op. Four empty kernels mark the step's
phases for a device trace (ops/phase.py): forward, backward, optimizer
(from clipping on), end (after the EMA). Under a torch profiler each train
step is a host span (utils/profiling.py `span`, `caption.train_step`)
holding `prepare` (the lr, the key) and the graph layer's spans. The eval
step runs the same forward in eval mode under torch.inference_mode(), as
a program of the model's graph cache (JAX jits it, :103, :209;
`eager=True` runs it op by op). Both return device tensors that the
caller reads once per batch.

Under a data-parallel mesh (parallel/mesh.py; JAX shards dim 1 of the
stacked (S, N, ...) batches and dim 0 of the single-sentence ones over
`data`, :39-42, :93-100) each rank holds its rows. The caption loss is a
sum over tokens and the rows are independent, so the sum over ranks of
the gradients and of loss, n_correct and n_word is the global step's
(the mean cross entropy divides by the global token count, which the
step all-reduces and passes to the model); both are summed before
`caption_update`, so clipping, BertAdam and the EMA update alike on every
rank. Dropout folds the data rank into its seeds.

Under a `model` axis (parallel/tp.py; JAX's `state_shardings` :47-52)
recurrent MART runs its attention heads and FFN columns sharded over the
model group, which holds the same rows; the partial gradients are summed
over the group, and the global norm and BertAdam's per-tensor norms count
a sharded gradient over it. The attention-probability dropout on a rank's
heads draws its own mask; every other site the group's. The other caption
models run replicated under a `model` axis, as JAX runs them (its caption
steps take no state shardings): each model group repeats its data rank's
step.

The programs capture every collective of the step under NCCL (the
gradient and metric all-reduces, the token counts', tensor parallelism's
sums and gathers) after the eager first call has set the communicators
up; under gloo the steps run eagerly (parallel/mesh.py `capturable`).
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch

from coot_videotext_tpu_torch.models.caption.mtransformer import (
    MTransformer)
from coot_videotext_tpu_torch.models.caption.xl import TransformerXL
from coot_videotext_tpu_torch.ops import phase, philox
from coot_videotext_tpu_torch.ops.philox import dropout_seeds
from coot_videotext_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_grads, all_reduce_metrics, all_reduce_sum, capturable)
from coot_videotext_tpu_torch.parallel.tp import Layout
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    CaptionModel)
from coot_videotext_tpu_torch.train.loss_caption import (
    IGNORE, token_accuracy_counts)
from coot_videotext_tpu_torch.train.optim import (
    EMA, BertAdam, clip_by_global_norm)
from coot_videotext_tpu_torch.utils.graphs import (
    GraphCache, cache_of, programs_of, signature)
from coot_videotext_tpu_torch.utils.profiling import span
from coot_videotext_tpu_torch.utils.param_bridge import (
    mart_jax_paths, mtrans_jax_paths, tied_aliases, xl_jax_paths)

# the global-norm clip of the train step, fixed by the JAX trainer
# (trainer.py:148-150), not read from cfg.train.clip_gradient
CLIP_GRADIENT = 1.0


@dataclasses.dataclass
class CaptionTrainState:
    """The model (float32 parameters), BertAdam (its moments keyed like the
    state dict, its step count and lr on the device), the EMA shadow (None
    without one), the seed state (a (1,) int64 tensor, ops/philox.py
    `seed_state`) and the step (an int32 scalar), both on the model's
    device (JAX CaptionTrainState :33); `mesh` the mesh of data and tensor
    parallelism (None: one process), `tp` the model's sharding
    (parallel/tp.py `shard_model_for_tp`) under a `model` axis;
    `programs` the captured train steps (`train_programs`)."""
    model: CaptionModel
    optimizer: BertAdam
    ema: Optional[EMA]
    seed: torch.Tensor
    step: torch.Tensor
    mesh: Optional[Mesh] = None
    tp: Optional[Layout] = None
    programs: Optional[GraphCache] = dataclasses.field(default=None,
                                                       repr=False)


def init_caption_train_state(model: CaptionModel, cfg, seed: int,
                             mesh: Optional[Mesh] = None
                             ) -> CaptionTrainState:
    """The train state of `model` on its device (JAX
    init_caption_train_state :140 and MartTrainer :108-116): BertAdam with
    eps = cfg.eps, its masks on the parameters' JAX paths, the word
    embeddings frozen under use_glove + freeze_glove; the EMA when
    cfg.ema_decay > 0; the seed state of `seed`; step 0."""
    params = dict(model.named_parameters())
    if isinstance(model, MTransformer):
        paths = mtrans_jax_paths(model)
    elif isinstance(model, TransformerXL):
        paths = xl_jax_paths(model)
    else:  # MART, the untied and the joint single-sentence models
        paths = mart_jax_paths(model)
    device = next(iter(params.values())).device
    frozen = (("word_embeddings",) if cfg.use_glove and cfg.freeze_glove
              else ())
    return CaptionTrainState(
        model=model,
        optimizer=BertAdam(params, paths, eps=cfg.eps,
                           frozen_names=frozen),
        ema=(EMA(params, cfg.ema_decay, tied_aliases(model))
             if cfg.ema_decay > 0 else None),
        seed=philox.seed_state(seed, device),
        step=torch.zeros((), dtype=torch.int32, device=device), mesh=mesh)


def _token_counts(labels: torch.Tensor, mesh: Optional[Mesh]
                  ) -> Optional[torch.Tensor]:
    """The valid tokens of the global batch under a data-parallel mesh,
    one count a sentence step of stacked (S, N, L) labels, one of (N, L)
    labels (one all-reduce); None in one process."""
    if mesh is None or not mesh.data_parallel:
        return None
    valid = (labels != IGNORE).float()
    counts = valid.sum() if labels.dim() == 2 else valid.sum(dim=(1, 2))
    return all_reduce_sum(mesh, counts)


def _forward(model: CaptionModel, batch: Dict[str, torch.Tensor],
             mesh: Optional[Mesh] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, n_correct, n_word) of the S-step forward in the model's
    mode, the rank's part of the global batch's under `mesh`."""
    loss, scores_list = model(
        batch["input_ids"], batch["video_feature"], batch["input_mask"],
        batch["token_type_ids"], batch["input_labels"],
        token_counts=_token_counts(batch["input_labels"], mesh))
    n_correct = loss.new_zeros(())
    n_word = loss.new_zeros(())
    with torch.no_grad():
        for idx, scores in enumerate(scores_list):
            c, w = token_accuracy_counts(scores, batch["input_labels"][idx])
            n_correct = n_correct + c
            n_word = n_word + w
    return loss, n_correct, n_word


def _forward_single(model: CaptionModel, batch: Dict[str, torch.Tensor],
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, n_correct, n_word) of the single-sentence forward in the
    model's mode (JAX `_single_forward` :152): an untied batch (labels
    from text_labels) or a joint one (from input_labels)."""
    if "text_ids" in batch:
        labels = batch["text_labels"]
        loss, scores = model(batch["video_feature"], batch["video_mask"],
                             batch["text_ids"], batch["text_mask"], labels,
                             _token_counts(labels, mesh))
    else:
        labels = batch["input_labels"]
        loss, scores = model(batch["input_ids"], batch["video_feature"],
                             batch["input_mask"], batch["token_type_ids"],
                             labels, _token_counts(labels, mesh))
    with torch.no_grad():
        n_correct, n_word = token_accuracy_counts(scores, labels)
    return loss, n_correct, n_word


def caption_loss_and_grads(state: CaptionTrainState,
                           batch: Dict[str, torch.Tensor], *,
                           single: bool = False
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor]]:
    """The training forward (dropout on, seeded by the state) and its
    backward: ({loss, n_correct, n_word} detached, the float32 gradient of
    every parameter by name; zeros where the loss does not reach, as under
    jax.grad). `single`: a single-sentence batch (untied or joint). Under a
    mesh both are summed over its ranks."""
    model = state.model
    model.train()
    params = state.optimizer.params
    phase.mark("forward", state.seed)
    forward = _forward_single if single else _forward
    mesh = state.mesh
    ranks = (mesh.data_rank, mesh.model_rank) if mesh is not None else ()
    with dropout_seeds(state.seed, *ranks):
        loss, n_correct, n_word = forward(model, batch, mesh)
    phase.mark("backward", state.seed)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    if state.tp is not None:
        grads = state.tp.reduce_partial(grads)
    metrics = {"loss": loss.detach(), "n_correct": n_correct,
               "n_word": n_word}
    return all_reduce_metrics(mesh, metrics), all_reduce_grads(mesh, grads)


def caption_update(state: CaptionTrainState,
                   grads: Dict[str, torch.Tensor], lr: Optional[float]
                   ) -> torch.Tensor:
    """The step after the backward: clipping by the global norm to
    CLIP_GRADIENT (the gradients in place), BertAdam at `lr` (None: the lr
    filled into BertAdam's device lr), the EMA with the step before its
    increment, then step + 1 and seed state + 1, between the optimizer and
    end phase marks. Returns the pre-clip norm."""
    phase.mark("optimizer", state.seed)
    norm = clip_by_global_norm(grads, CLIP_GRADIENT, state.tp)
    state.optimizer.step(grads, lr, state.tp)
    if state.ema is not None:
        state.ema.update(state.step)
    state.step.add_(1)
    state.seed.add_(1)
    phase.mark("end", state.seed)
    return norm


def _state_tensors(state: CaptionTrainState) -> Iterable[torch.Tensor]:
    """Every tensor a train program reads or writes besides its inputs."""
    opt = state.optimizer
    return itertools.chain(
        state.model.parameters(), state.model.buffers(),
        opt.params.values(), opt.mu.values(), opt.nu.values(),
        (opt.step_count, opt.lr, state.seed, state.step),
        state.ema.shadow.values() if state.ema is not None else ())


def train_programs(state: CaptionTrainState) -> GraphCache:
    """The state's cache of captured train steps (made at the first call),
    checked: valid while every tensor of `_state_tensors` keeps its
    address."""
    return programs_of(state, _state_tensors)


def _step(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
          lr: Optional[float], single: bool) -> Dict[str, torch.Tensor]:
    metrics, grads = caption_loss_and_grads(state, batch, single=single)
    metrics["grad_norm"] = caption_update(state, grads, lr)
    return metrics


def _train(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
           lr: float, single: bool, eager: bool) -> Dict[str, torch.Tensor]:
    """One train step: eagerly with `eager` or under a gloo mesh of more
    than one rank, else the program of the batch's shapes (a stateful
    program: its first call is the step, every later one a replay), which
    reads the lr filled into BertAdam's device lr."""
    with span("caption.train_step"):
        if eager or not capturable(state.mesh):
            return _step(state, batch, lr, single)
        ref = weakref.ref(state)  # the cache on the state holds the body
        with span("prepare"):
            inputs = {k: v for k, v in batch.items() if torch.is_tensor(v)}
            state.optimizer.lr.fill_(lr)
            key = ("caption_train", single, signature(inputs))
        return train_programs(state).get(
            key, lambda x: _step(ref(), x, None, single), inputs,
            stateful=True)(inputs)


def caption_train_step(state: CaptionTrainState,
                       batch: Dict[str, torch.Tensor], lr: float, *,
                       eager: bool = False) -> Dict[str, torch.Tensor]:
    """One train step on a stacked (S, N, ...) batch on the model's device;
    returns {loss (sum over steps), n_correct, n_word, grad_norm} as 0-d
    float32 device tensors. The parameters, the optimizer, the EMA, the
    step and the seed state are updated in place. A captured program
    (`_train`) unless `eager`: on the card the tensors after a shape's
    first call are the graph's outputs, valid until the next call of a
    train program of the state (train_model reads them first)."""
    return _train(state, batch, lr, False, eager)


def caption_train_step_single(state: CaptionTrainState,
                              batch: Dict[str, torch.Tensor], lr: float, *,
                              eager: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """caption_train_step on an (N, ...) sentence batch, untied or joint
    (JAX make_caption_train_step_single :167)."""
    return _train(state, batch, lr, True, eager)


def _eval(model: CaptionModel, batch: Dict[str, torch.Tensor],
          mesh: Optional[Mesh], single: bool, eager: bool
          ) -> Dict[str, torch.Tensor]:
    """The eval step (`_forward` or `_forward_single` in eval mode, summed
    over the mesh's ranks) as a program of the model's graph cache
    (utils/graphs.py; JAX jits it), keyed on the batch's shapes and dtypes:
    a CUDA graph on the card, its body run eagerly on its static buffers
    on the CPU; eagerly with `eager` or under a gloo mesh of more than
    one rank (parallel/mesh.py `capturable`)."""
    forward = _forward_single if single else _forward

    def body(x):
        model.eval()
        loss, n_correct, n_word = forward(model, x, mesh)
        return all_reduce_metrics(mesh, {"loss": loss, "n_correct": n_correct,
                                         "n_word": n_word})
    with torch.inference_mode():
        if eager or not capturable(mesh):
            return body(batch)
        inputs = {k: v for k, v in batch.items() if torch.is_tensor(v)}
        key = ("caption_eval", single, signature(inputs), id(mesh))
        return cache_of(model).get(key, body, inputs)(inputs)


def caption_eval_step(model: CaptionModel,
                      batch: Dict[str, torch.Tensor],
                      mesh: Optional[Mesh] = None, *, eager: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """{loss (sum over steps), n_correct, n_word} of one stacked batch,
    as 0-d f32 tensors on the batch's device; under a mesh summed over its
    ranks. A captured program (`_eval`) unless `eager`: on the card the
    tensors are the graph's outputs, valid until the next run of a
    program of the model's graph cache (validate_epoch reads them first)."""
    return _eval(model, batch, mesh, False, eager)


def caption_eval_step_single(model: CaptionModel,
                             batch: Dict[str, torch.Tensor],
                             mesh: Optional[Mesh] = None, *,
                             eager: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """caption_eval_step on an (N, ...) sentence batch, untied or joint
    (JAX make_caption_eval_step_single :209)."""
    return _eval(model, batch, mesh, True, eager)
