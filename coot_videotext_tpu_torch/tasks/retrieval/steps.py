"""
Retrieval train and eval steps (port of coot_videotext_tpu/tasks/retrieval/
steps.py: `make_retrieval_train_step` :41 per step, with its store, device
sampling and slab modes :69-96, `make_retrieval_train_scan` :234, the
group of K steps, and `make_retrieval_eval_step` :144-209).

The train step first builds the dense batch on the device
(data/device_store.py `assemble_batch`): an id batch is sampled with the
train jitter, index and slab batches gather their rows through B5, store
gathers with the frame/word noise. Then it runs the 4-net forward in the
compute dtype with dropout on, the total loss (with the cycle-consistency
subsampling), the backward through autograd and the kernels' backward,
the optional global-norm clipping, the optimizer update in place, and
advances the state's seed state by one. Four empty kernels mark its
phases for a device trace (ops/phase.py): forward, backward, optimizer,
end. Every random draw of the step is keyed on that seed state
(ops/philox.py): the jitter and the subsampling on the state itself, the
noise and each dropout on (state, call), the call's position in the step.
Nothing in the step reads a value back to the host.

The group step (`retrieval_train_group`) runs up to K such steps on id
batches from a (K, B) id array, as calls of a stateful program of the
train state's graph cache (utils/graphs.py, `train_programs`): the step
reads its ids and validity at a device step index, writes its metrics
into that row of a (K, M) buffer and advances the index, so on the card a
group is K replays of a CUDA graph of one step with no host work between
them, and a tail group is just fewer replays (JAX runs identity steps on
its padding, :252-256, :308-310). The program is captured once per (K, B,
dtype, source, loss settings); its first call, the capture's eager run,
is a real step of the group. On the CPU the program's body runs eagerly,
step by step. Either way K grouped steps equal K per-step calls on the
same state.

The eval step builds its batch the same way with center sampling and no
noise, runs the forward in eval mode and returns the val loss parts and
the raw and L2-normalized embeddings, all on the batch's device. It runs
as a program of the model's graph cache (utils/graphs.py): a CUDA graph
on the card, captured once per layout, shapes and loss settings and
replayed after each batch is copied into its static buffers, as JAX jits
it (:144-220); `eager=True` runs it op by op.

Under a torch profiler each call of the group and of the eval step is a
host span (utils/profiling.py `span`: `retrieval.train_group`,
`retrieval.eval_step`) holding `prepare` (its own host work before the
program: the lr, the host arrays, the key) and the graph layer's spans.

Data parallelism (parallel/mesh.py, JAX's `data` axis :125-141, :211-221,
:319-330): under a mesh of W > 1 ranks each rank's batch holds its rows of
the global batch. The step gathers the loss inputs of every rank
(`all_gather_rows`, in rank order) and computes the global loss on every
rank, so the contrastive negatives and the cycle-consistency draws are
those of the global batch (the avg_special pool, which sums up to the
batch's longest sequence, takes the global batch's longest, which the
step all-reduces and passes to the model); the backward keeps the rank's
rows, and the
gradients are summed over ranks in one all-reduce before clipping. The
jitter's uniforms are drawn for the global batch (data/device_store.py
`assemble_batch`); dropout and the store's noise fold the data rank into
their seeds (ops/philox.py `dropout_seeds`). The eval step gathers its loss
inputs the same way and returns the rank's rows of the embeddings. The
group step captures its collectives into the CUDA graph under NCCL (the
first, eager step of the group has run them on the capture's stream);
under gloo, whose collectives run on the host, it runs its steps eagerly.
At W = 1 nothing of this runs.

Tensor parallelism (parallel/tp.py, JAX's `state_shardings` :48, :240):
under a `model` axis the ranks of one model group hold the same rows and
run the model's sharded layers together (their collectives are the
layers'); the step sums the partial gradients over the model group
(`Layout.reduce_partial`) before the data all-reduce, and the global norm
counts each sharded gradient over the group. A replicated dropout site
draws the same mask on every rank of the group; B3 on a rank's heads
draws its own.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.data.device_store import (
    FeatureSource, assemble_batch)
from coot_videotext_tpu_torch.models.retrieval import (
    LENGTH_KEYS, RetrievalModel)
from coot_videotext_tpu_torch.ops import phase
from coot_videotext_tpu_torch.ops.philox import dropout_seeds, next_seed
from coot_videotext_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_grads, all_reduce_max, capturable)
from coot_videotext_tpu_torch.parallel.tp import Layout
from coot_videotext_tpu_torch.train.losses import (
    compute_total_retrieval_loss, l2_normalize)
from coot_videotext_tpu_torch.train.optim import clip_by_global_norm
from coot_videotext_tpu_torch.utils.graphs import (
    GraphCache, Program, cache_of, programs_of, signature)
from coot_videotext_tpu_torch.utils.profiling import span

VISUAL_KEYS = ("vid_emb", "clip_emb", "vid_context", "clip_valid",
               "clip_num")
TEXT_KEYS = ("par_emb", "sent_emb", "par_context", "sent_valid", "sent_num")
EMB_KEYS = ("vid_emb", "par_emb", "clip_emb", "sent_emb", "vid_context",
            "par_context")


@dataclasses.dataclass
class TrainState:
    """The model (float32 parameters), its optimizer (float32 state, keyed
    like the state dict, its step count and learning rate on the device),
    the seed state (a (1,) int64 tensor on the model's device, ops/philox.py
    `seed_state`; None: no random draws, so dropout raises and id batches
    are refused) and the host's count of steps taken (JAX TrainState :34
    and the rng split of :78). `mesh`: the mesh of data and tensor
    parallelism (None: one process); `tp` the model's sharding
    (parallel/tp.py `shard_model_for_tp`, JAX's `state_shardings`) when
    it has a `model` axis; `programs` the group's captured steps
    (`train_programs`)."""
    model: RetrievalModel
    optimizer: object
    seed: Optional[torch.Tensor] = None
    step: int = 0
    mesh: Optional[Mesh] = None
    tp: Optional[Layout] = None
    programs: Optional[GraphCache] = dataclasses.field(default=None,
                                                       repr=False)


def _loss_inputs(out: Dict[str, torch.Tensor], batch_valid: torch.Tensor,
                 mesh: Optional[Mesh]):
    """(visual, text, batch_valid) of the loss: every rank's rows under a
    data-parallel mesh."""
    visual = {k: all_gather_rows(mesh, out[k]) for k in VISUAL_KEYS}
    text = {k: all_gather_rows(mesh, out[k]) for k in TEXT_KEYS}
    return visual, text, all_gather_rows(mesh, batch_valid)


def _longest(batch: Dict[str, torch.Tensor], mesh: Optional[Mesh]
             ) -> Optional[Dict[str, torch.Tensor]]:
    """The global batch's longest lengths (`LENGTH_KEYS`) under a
    data-parallel mesh, by one all-reduce; None in one process."""
    if mesh is None or not mesh.data_parallel:
        return None
    local = torch.stack([batch[k].max().to(torch.int64)
                         for k in LENGTH_KEYS])
    return dict(zip(LENGTH_KEYS, all_reduce_max(mesh, local)))


def retrieval_loss_and_grads(
        state: TrainState, batch: Dict[str, Any], *,
        loss_weights: Dict[str, float], margin: float,
        loss_cycle_cons: float,
        compute_dtype: torch.dtype = torch.float32,
        source: Optional[FeatureSource] = None
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The training batch assembly, forward (dropout on) and backward:
    (detached loss parts, float32 gradient of every parameter by name). A
    parameter that the loss does not reach gets a zero gradient, as under
    jax.grad."""
    if batch.get("layout") == "ids" and state.seed is None:
        raise ValueError("training on id batches needs the state's seed "
                         "state")
    model = state.model
    model.train()
    params = state.optimizer.params
    like = next(iter(params.values()))
    phase.mark("forward", like)
    mesh = state.mesh
    ranks = (mesh.data_rank, mesh.model_rank) if mesh is not None else ()
    with dropout_seeds(state.seed, *ranks):
        noise_seed = None
        if source is not None and source.noisy and state.seed is not None:
            noise_seed = next_seed()
        batch = assemble_batch(batch, source, sample_state=state.seed,
                               noise_seed=noise_seed, mesh=mesh)
        out = model(batch, compute_dtype=compute_dtype,
                    max_lengths=_longest(batch, mesh))
    visual, text, batch_valid = _loss_inputs(out, batch["batch_valid"], mesh)
    loss, parts = compute_total_retrieval_loss(
        visual, text, loss_weights, margin, loss_cycle_cons,
        seed_state=state.seed, batch_valid=batch_valid)
    phase.mark("backward", like)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    if state.tp is not None:
        grads = state.tp.reduce_partial(grads)
    return ({k: v.detach() for k, v in parts.items()},
            all_reduce_grads(mesh, grads))


def _train_step_body(state: TrainState, batch: Dict[str, Any], *,
                     lr: Optional[float], loss_weights: Dict[str, float],
                     margin: float, loss_cycle_cons: float,
                     clip_gradient: float, compute_dtype: torch.dtype,
                     source: Optional[FeatureSource]
                     ) -> Dict[str, torch.Tensor]:
    """One step on the device, without touching the host's step count:
    the body that the per-step call runs and the group step captures. lr
    None: the optimizer's learning rate as filled in. Under a mesh the
    loss parts are the global batch's, the same on every rank, and the
    gradients are clipped after their sum over ranks."""
    metrics, grads = retrieval_loss_and_grads(
        state, batch, loss_weights=loss_weights, margin=margin,
        loss_cycle_cons=loss_cycle_cons, compute_dtype=compute_dtype,
        source=source)
    like = next(iter(state.optimizer.params.values()))
    phase.mark("optimizer", like)
    if clip_gradient > 0:
        metrics["grad_norm"] = clip_by_global_norm(grads, clip_gradient,
                                                   state.tp)
    state.optimizer.step(grads, lr)
    if state.seed is not None:
        state.seed.add_(1)
    phase.mark("end", like)
    return metrics


def retrieval_train_step(state: TrainState, batch: Dict[str, Any],
                         *, lr: float, loss_weights: Dict[str, float],
                         margin: float, loss_cycle_cons: float,
                         clip_gradient: float = -1.0,
                         compute_dtype: torch.dtype = torch.float32,
                         source: Optional[FeatureSource] = None
                         ) -> Dict[str, torch.Tensor]:
    """One training step on any loader batch (`source` names the store and
    device metadata of index and id batches); returns the detached loss
    parts (and `grad_norm` with clipping, as the reference computes the
    norm only then, trainer_base.py:545-554). The parameters, the
    optimizer state and the seed state are updated in place."""
    metrics = _train_step_body(
        state, batch, lr=lr, loss_weights=loss_weights, margin=margin,
        loss_cycle_cons=loss_cycle_cons, clip_gradient=clip_gradient,
        compute_dtype=compute_dtype, source=source)
    state.step += 1
    return metrics


def _host_array(x, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _state_tensors(state: TrainState) -> Iterable[torch.Tensor]:
    """Every tensor a group program reads or writes besides its inputs."""
    opt = state.optimizer
    return itertools.chain(
        state.model.parameters(), state.model.buffers(),
        opt.params.values(), opt.mu.values(), opt.nu.values(),
        (opt.step_count, opt.lr, state.seed))


def train_programs(state: TrainState) -> GraphCache:
    """The state's cache of group programs (made at the first call),
    checked: valid while every tensor of `_state_tensors` keeps its
    address."""
    return programs_of(state, _state_tensors)


def _group_program(state: TrainState, k: int, b: int,
                   step_kw: Dict[str, Any]) -> Program:
    """The stateful program of one step on id batches: it reads the ids
    and validity of row `index` of its (K, B) inputs `ids` and `valid`,
    writes its metrics into that row of a (K, M) buffer (made by its first
    run, which names the columns) and advances `index`, all on the device;
    it returns the buffer's columns by name."""
    ref = weakref.ref(state)  # the cache on the state holds the body
    names: list = []
    rows: list = []

    def body(x):
        batch = {"layout": "ids",
                 "dp_idx": x["ids"].index_select(0, x["index"])[0],
                 "batch_valid": x["valid"].index_select(0, x["index"])[0]}
        metrics = _train_step_body(ref(), batch, lr=None, **step_kw)
        if not rows:  # the eager first run names the columns
            names.extend(metrics)
            rows.append(torch.zeros((k, len(names)), dtype=torch.float32,
                                    device=x["ids"].device))
        row = torch.stack([metrics[n].float().reshape(()) for n in names])
        rows[0].index_copy_(0, x["index"], row[None])
        x["index"].add_(1)
        return {n: rows[0][:, j] for j, n in enumerate(names)}
    device = state.seed.device
    inputs = {"ids": torch.zeros((k, b), dtype=torch.int32, device=device),
              "valid": torch.zeros((k, b), dtype=torch.bool, device=device),
              "index": torch.zeros(1, dtype=torch.int64, device=device)}
    return train_programs(state).get(_group_key(k, b, step_kw), body,
                                     inputs, stateful=True)


def _group_key(k, b, step_kw):
    src = step_kw["source"]
    return (k, b, step_kw["compute_dtype"], step_kw["clip_gradient"],
            step_kw["margin"], step_kw["loss_cycle_cons"],
            tuple(sorted(step_kw["loss_weights"].items())), id(src.store),
            id(src.meta), src.frames_noise, src.words_noise)


def retrieval_train_group(state: TrainState, dp_idx, batch_valid,
                          num_steps: int, *, lr: float,
                          loss_weights: Dict[str, float], margin: float,
                          loss_cycle_cons: float,
                          clip_gradient: float = -1.0,
                          compute_dtype: torch.dtype = torch.float32,
                          source: FeatureSource
                          ) -> Dict[str, torch.Tensor]:
    """
    Steps 0 .. num_steps-1 of a group of id batches, each as
    `retrieval_train_step` on {"layout": "ids", "dp_idx": dp_idx[i],
    "batch_valid": batch_valid[i]} (JAX `make_retrieval_train_scan` :234).

    Args:
        state: its seed state on the model's device
        dp_idx: (K, B) datapoint ids (int, on the host)
        batch_valid: (K, B) bool, on the host
        num_steps: 1 <= num_steps <= K; the rows past it are not run
        lr: the learning rate of the whole group
        source: the loader's FeatureSource with device metadata (id batches)

    Returns each metric of the step stacked over the group: (num_steps,)
    float32 on the device. Under a gloo mesh of more than one rank the
    steps run eagerly (parallel/mesh.py `capturable`).
    """
    with span("retrieval.train_group"):
        k, b = dp_idx.shape
        if not 1 <= num_steps <= k:
            raise ValueError(f"num_steps {num_steps} outside [1, {k}]")
        mesh = state.mesh
        if source is None or source.meta is None or state.seed is None:
            raise ValueError("the group step takes id batches: a source "
                             "with device metadata and a state with a seed "
                             "state")
        step_kw = dict(loss_weights=loss_weights, margin=margin,
                       loss_cycle_cons=loss_cycle_cons,
                       clip_gradient=clip_gradient,
                       compute_dtype=compute_dtype, source=source)
        device = state.seed.device
        graphed = capturable(mesh)
        with span("prepare"):
            state.optimizer.lr.fill_(lr)
            ids = _host_array(dp_idx, torch.int32)
            valid = _host_array(batch_valid, torch.bool)
            if graphed and device.type == "cuda":
                ids, valid = ids.pin_memory(), valid.pin_memory()
        if not graphed:
            ids, valid = ids.to(device), valid.to(device)
            rows = [_train_step_body(
                state, {"layout": "ids", "dp_idx": ids[i],
                        "batch_valid": valid[i]}, lr=None, **step_kw)
                for i in range(num_steps)]
            metrics = {n: torch.stack([r[n].float() for r in rows])
                       for n in rows[0]}
        else:
            program = _group_program(state, k, b, step_kw)
            program.load({"ids": ids, "valid": valid})
            program.inputs["index"].zero_()
            for _ in range(num_steps):
                out = program()
            # copies: the buffer is the next group's
            metrics = {n: v[:num_steps].clone() for n, v in out.items()}
        state.step += num_steps
        return metrics


def _eval_body(model: RetrievalModel, batch: Dict[str, Any], *,
               loss_weights: Dict[str, float], margin: float,
               loss_cycle_cons: float, compute_dtype: torch.dtype,
               seed_state: Optional[torch.Tensor],
               source: Optional[FeatureSource], mesh: Optional[Mesh]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The eval step's device work: assembly, forward, loss, embeddings."""
    batch = assemble_batch(batch, source, mesh=mesh)
    model.eval()
    out = model(batch, compute_dtype=compute_dtype,
                max_lengths=_longest(batch, mesh))
    visual, text, batch_valid = _loss_inputs(out, batch["batch_valid"], mesh)
    _, parts = compute_total_retrieval_loss(
        visual, text, loss_weights, margin, loss_cycle_cons,
        seed_state=seed_state, batch_valid=batch_valid)
    embs = {f"{k}_before_norm": out[k] for k in EMB_KEYS}
    embs.update({k: l2_normalize(out[k]) for k in EMB_KEYS})
    for k in ("clip_valid", "sent_valid", "clip_num", "sent_num"):
        embs[k] = out[k]
    return embs, parts


@torch.inference_mode()
def retrieval_eval_step(model: RetrievalModel,
                        batch: Dict[str, Any], *,
                        loss_weights: Dict[str, float], margin: float,
                        loss_cycle_cons: float,
                        compute_dtype: torch.dtype = torch.float32,
                        seed_state: Optional[torch.Tensor] = None,
                        source: Optional[FeatureSource] = None,
                        mesh: Optional[Mesh] = None,
                        eager: bool = False
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Returns (embeddings, loss parts) of any loader batch (center
    sampling, no noise). `seed_state` keys the cycle-consistency
    subsampling (ops/philox.py); None takes its deterministic full mean.
    Under a data-parallel `mesh` the loss parts are the global batch's and
    the embeddings the rank's rows (JAX :220, out_shardings (data, rep)).

    The step is a program of the model's graph cache (utils/graphs.py,
    JAX jits it, :144-220), keyed on the batch's layout, shapes and dtypes,
    the loss settings, the seed state's presence and the source: on the
    card a CUDA graph (B5 and the forward halves of B1-B3 inside it),
    replayed after the batch's
    tensors and the seed state are copied into its static buffers; on the
    CPU its body runs eagerly on them. The returned tensors are then views
    of the program's outputs, valid until the next run of a program of the
    model's cache: the caller reads them before the next step
    (validate_retrieval copies them to the host). `eager` runs the step
    eagerly, as it also runs under a gloo mesh of more than one rank
    (parallel/mesh.py `capturable`); a batch whose shapes vary (host
    dense batches) is best run so, since each new shape is a new
    capture."""
    kw = dict(loss_weights=loss_weights, margin=margin,
              loss_cycle_cons=loss_cycle_cons, compute_dtype=compute_dtype,
              source=source, mesh=mesh)
    with span("retrieval.eval_step"):
        if eager or not capturable(mesh):
            return _eval_body(model, batch, seed_state=seed_state, **kw)
        with span("prepare"):
            layout = batch.get("layout", "dense")
            inputs = {"batch": {k: v for k, v in batch.items()
                                if torch.is_tensor(v)}}
            if seed_state is not None:
                inputs["seed"] = seed_state
            key = ("retrieval_eval", layout, signature(inputs),
                   compute_dtype, margin, loss_cycle_cons,
                   tuple(sorted(loss_weights.items())),
                   None if source is None
                   else (id(source.store), id(source.meta)), id(mesh))

        def body(x):
            return _eval_body(model, {**x["batch"], "layout": layout},
                              seed_state=x.get("seed"), **kw)
        return cache_of(model).get(key, body, inputs)(inputs)
