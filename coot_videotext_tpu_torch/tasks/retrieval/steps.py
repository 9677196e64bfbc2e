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
advances the state's seed state by one. Every random draw of the step is
keyed on that seed state (ops/philox.py): the jitter and the subsampling
on the state itself, the noise and each dropout on (state, call), the
call's position in the step. Nothing in the step reads a value back to the
host.

The group step (`retrieval_train_group`) runs up to K such steps on id
batches from a (K, B) id array. On the card it replays a CUDA graph of one
step (`StepGraph`): the step reads its ids and validity at a device step
index, writes its metrics into that row of a (K, M) buffer and advances
the index, so a group is K replays with no Python between them, and a tail
group is just fewer replays (JAX runs identity steps on its padding,
:252-256, :308-310). The graph is captured once per (K, B, dtype, source,
loss settings) after a first step run eagerly on the capture's stream;
that first step is a real step of the group. On the CPU the group runs the
same step body eagerly, step by step. Either way K grouped steps equal K
per-step calls on the same state.

The eval step builds its batch the same way with center sampling and no
noise, runs the forward in eval mode and returns the val loss parts and
the raw and L2-normalized embeddings, all on the batch's device.

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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.data.device_store import (
    FeatureSource, assemble_batch)
from coot_videotext_tpu_torch.models.retrieval import (
    LENGTH_KEYS, RetrievalModel)
from coot_videotext_tpu_torch.ops.philox import dropout_seeds, next_seed
from coot_videotext_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_grads, all_reduce_max)
from coot_videotext_tpu_torch.parallel.tp import Layout
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
    like the state dict, its step count and learning rate on the device),
    the seed state (a (1,) int64 tensor on the model's device, ops/philox.py
    `seed_state`; None: no random draws, so dropout raises and id batches
    are refused) and the host's count of steps taken (JAX TrainState :34
    and the rng split of :78). `graph` caches the captured step of
    `retrieval_train_group` on the card. `mesh`: the mesh of data and
    tensor parallelism (None: one process); `tp` the model's sharding
    (parallel/tp.py `shard_model_for_tp`, JAX's `state_shardings`) when
    it has a `model` axis."""
    model: RetrievalModel
    optimizer: object
    seed: Optional[torch.Tensor] = None
    step: int = 0
    graph: Optional["StepGraph"] = None
    mesh: Optional[Mesh] = None
    tp: Optional[Layout] = None


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
    if clip_gradient > 0:
        metrics["grad_norm"] = clip_by_global_norm(grads, clip_gradient,
                                                   state.tp)
    state.optimizer.step(grads, lr)
    if state.seed is not None:
        state.seed.add_(1)
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


class StepGraph:
    """One train step on id batches captured as a CUDA graph. The step
    reads the ids and validity of row `index` of the static (K, B) buffers
    `ids` and `valid`, writes its metrics (the columns `names`) into that
    row of `metrics` and advances `index`, all on the device. The first
    step runs eagerly on `stream` and is a real step; the capture that
    follows on the same stream runs nothing. The kernels' launch counts
    (ops/cuda_build.py) rise where their wrappers run: in the eager step and
    once more at the capture; a replay runs no Python and counts nothing.
    Under an NCCL mesh the eager step's collectives run on `stream` before
    the capture, so the communicator is set up and warm when the capture
    records them."""

    def __init__(self, key, device: torch.device, k: int, b: int,
                 step_kw: Dict[str, Any]) -> None:
        self.key = key
        self.step_kw = step_kw
        self.ids = torch.zeros((k, b), dtype=torch.int32, device=device)
        self.valid = torch.zeros((k, b), dtype=torch.bool, device=device)
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.stream = torch.cuda.Stream(device)
        self.names: Tuple[str, ...] = ()
        self.metrics: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _step(self, state: TrainState) -> None:
        batch = {"layout": "ids",
                 "dp_idx": self.ids.index_select(0, self.index)[0],
                 "batch_valid": self.valid.index_select(0, self.index)[0]}
        metrics = _train_step_body(state, batch, lr=None, **self.step_kw)
        if self.metrics is None:  # the eager first step names the columns
            self.names = tuple(metrics)
            self.metrics = torch.zeros(
                (self.ids.shape[0], len(self.names)), dtype=torch.float32,
                device=self.ids.device)
        row = torch.stack([metrics[n].float().reshape(())
                           for n in self.names])
        self.metrics.index_copy_(0, self.index, row[None])
        self.index.add_(1)

    def run(self, state: TrainState, num_steps: int) -> None:
        """Steps 0 .. num_steps-1 of the group whose ids and validity are
        in the buffers, on `state` (always the same one: the graph holds
        its tensors' addresses): the first of all groups eagerly, then the
        capture; every other step is a replay."""
        self.index.zero_()
        if self.graph is None:
            current = torch.cuda.current_stream(self.ids.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self._step(state)
            current.wait_stream(self.stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.stream):
                self._step(state)
            self.graph = graph
            num_steps -= 1
        for _ in range(num_steps):
            self.graph.replay()


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
    float32 on the device. On the card these are views of the captured
    step's buffer, valid until the state's next group.
    """
    k, b = dp_idx.shape
    if not 1 <= num_steps <= k:
        raise ValueError(f"num_steps {num_steps} outside [1, {k}]")
    mesh = state.mesh
    if source is None or source.meta is None or state.seed is None:
        raise ValueError("the group step takes id batches: a source with "
                         "device metadata and a state with a seed state")
    step_kw = dict(loss_weights=loss_weights, margin=margin,
                   loss_cycle_cons=loss_cycle_cons,
                   clip_gradient=clip_gradient, compute_dtype=compute_dtype,
                   source=source)
    state.optimizer.lr.fill_(lr)
    device = state.seed.device
    if device.type == "cpu" or (mesh is not None and not mesh.capturable):
        ids = _host_array(dp_idx, torch.int32).to(device)
        valid = _host_array(batch_valid, torch.bool).to(device)
        rows = [_train_step_body(state, {"layout": "ids", "dp_idx": ids[i],
                                         "batch_valid": valid[i]},
                                 lr=None, **step_kw)
                for i in range(num_steps)]
        metrics = {n: torch.stack([r[n].float() for r in rows])
                   for n in rows[0]}
    else:
        key = _group_key(k, b, step_kw)
        if state.graph is None or state.graph.key != key:
            state.graph = None  # frees the old graph's pool first
            state.graph = StepGraph(key, device, k, b, step_kw)
        graph = state.graph
        for buf, host, dtype in ((graph.ids, dp_idx, torch.int32),
                                 (graph.valid, batch_valid, torch.bool)):
            buf.copy_(_host_array(host, dtype).pin_memory(),
                      non_blocking=True)
        graph.run(state, num_steps)
        metrics = {n: graph.metrics[:num_steps, j]
                   for j, n in enumerate(graph.names)}
    state.step += num_steps
    return metrics


@torch.inference_mode()
def retrieval_eval_step(model: RetrievalModel,
                        batch: Dict[str, torch.Tensor], *,
                        loss_weights: Dict[str, float], margin: float,
                        loss_cycle_cons: float,
                        compute_dtype: torch.dtype = torch.float32,
                        seed_state: Optional[torch.Tensor] = None,
                        source: Optional[FeatureSource] = None,
                        mesh: Optional[Mesh] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Returns (embeddings, loss parts) of any loader batch (center
    sampling, no noise). `seed_state` keys the cycle-consistency
    subsampling (ops/philox.py); None takes its deterministic full mean.
    Under a data-parallel `mesh` the loss parts are the global batch's and
    the embeddings the rank's rows (JAX :220, out_shardings (data, rep))."""
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
