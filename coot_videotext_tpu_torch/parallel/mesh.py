"""
Data parallelism over ranks, and the 2-D mesh of data and tensor
parallelism: the `data` and `model` axes of the JAX package's mesh.

Port of coot_videotext_tpu/parallel/mesh.py (`get_mesh` :31, `batch_sharding`
:52, `replicated_sharding` :57, `shard_params` :62). JAX runs one program
over a device mesh and GSPMD inserts the collectives; here each rank is a
process with one device. A mesh {"data": D, "model": M} has D x M ranks,
`rank = data_rank * M + model_rank` (JAX's row-major reshape of the
devices, :47, with `model` the fast axis): the M ranks of one data rank
form its model group, the D ranks of one model rank its data group. The
parameters start replicated (the same seed, then `broadcast_params` from
rank 0); tensor parallelism then keeps each rank's slice of the sharded
ones (parallel/tp.py). Every batch is split by rows over the DATA ranks
(`batch_rows`): the ranks of one model group hold the same rows. The
collectives that GSPMD would insert on the `data` axis are explicit and
run over the data group:

    - `all_gather_rows`: the rows of every data rank, in rank order, with
      a backward that keeps the rank's own rows. The retrieval loss spans
      the global batch, so every rank gathers the loss inputs and computes
      the same global loss; the cotangent of the gathered tensor is then
      the same on every rank, and the rank's rows of it are the cotangent
      of its own rows. The gradients of the parameters are therefore
      SUMMED over data ranks (`all_reduce_grads`), not averaged.
    - `all_reduce_grads`: one all-reduce (sum) over a flat float32 buffer
      of every gradient, before clipping.
    - `all_reduce_metrics`: sums of per-rank metrics (caption losses and
      token counts, the MLP's weighted sums).
    - `all_reduce_sum`, `all_reduce_max`: the global batch's token counts
      (the mean cross entropy, train/loss_caption.py) and longest lengths
      (the reference's avg_special pool sums up to the longest sequence of
      the batch, models/poolers.py), which the steps compute and hand to
      the loss and the model as arguments.
    - `gather_objects`: host values of every data rank (keys).
The `model` axis's collectives are parallel/tp.py's. `broadcast_params`,
`broadcast_object` and `barrier` span every rank; rank 0 writes.

Without a data axis of more than one rank every data collective is
skipped, so a single process computes exactly what it computed before this
module existed. The reference's only parallelism is nn.DataParallel
(SURVEY.md §2.9); gradient sync is not handed to
nn.parallel.DistributedDataParallel, whose hooks fire on `.backward()`
(the steps take `torch.autograd.grad`) and whose wrapper would rename every
state-dict key.

Processes: `get_mesh` joins the process group that the caller (a test, a
spawned rank) has initialised, or initialises one from the variables that
torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
NCCL for CUDA devices, gloo for the CPU. Without them it is world 1 with no
process group. Under a `model` axis it makes the data and model groups
(`dist.new_group`, on the world's backend).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: its rank and the world size, the
    world's process group (None at world 1 without one), its backend, the
    rank's device, whether `get_mesh` initialised the group (`destroy`
    then ends it), the size of the `model` axis and the groups of the two
    axes (the data group None where the `data` axis has one rank; the
    model group None where the `model` axis has one)."""
    rank: int
    world: int
    device: torch.device
    group: Optional[Any] = None
    backend: Optional[str] = None
    owned: bool = False
    model_world: int = 1
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    def __post_init__(self) -> None:
        if self.model_world < 1 or self.world % self.model_world:
            raise ValueError(f"a `model` axis of {self.model_world} does "
                             f"not divide the world of {self.world}")
        if self.model_world == 1 and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)
        if self.data_world == 1 and self.model_group is None \
                and self.model_world > 1:
            object.__setattr__(self, "model_group", self.group)

    @property
    def data_world(self) -> int:
        """Ranks on the `data` axis."""
        return self.world // self.model_world

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_world

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_world

    @property
    def distributed(self) -> bool:
        """Whether any collective runs (world > 1)."""
        return self.world > 1

    @property
    def data_parallel(self) -> bool:
        """Whether the `data` axis has more than one rank."""
        return self.data_world > 1

    @property
    def tensor_parallel(self) -> bool:
        """Whether the `model` axis has more than one rank."""
        return self.model_world > 1

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files; every rank reads them."""
        return self.rank == 0



def capturable(mesh: Optional[Mesh]) -> bool:
    """Whether the group step (tasks/retrieval/steps.py `StepGraph`) is
    captured with its collectives under `mesh` (None: no mesh): NCCL
    collectives can be captured, gloo's run on the host. Its graph is
    released with its train state, before the process group ends."""
    return mesh is None or not mesh.distributed or mesh.backend == "nccl"


def serves_captured(mesh: Optional[Mesh]) -> bool:
    """Whether the eval steps and the caption decodes run as captured
    programs (utils/graphs.py) under `mesh`: the one rule of both eval
    steps, validation and the caption trainer's decodes. Only where no
    collective crosses ranks (no mesh, or one rank). Their programs live
    in the model's graph cache, which outlives a run; on four cards over
    NCCL a CLI run whose validations had gone through captured eval steps
    (and agreed across ranks) hung at exit until the NCCL watchdog aborted
    it, so under a mesh of more than one rank they run eagerly."""
    return mesh is None or not mesh.distributed


def single(device: torch.device = torch.device("cpu")) -> Mesh:
    """World 1 on `device`, no process group."""
    return Mesh(rank=0, world=1, device=torch.device(device))


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def get_mesh(mesh_shape: Optional[Dict[str, int]] = None,
             device_type: str = "cuda", *,
             device: Optional[torch.device] = None) -> Mesh:
    """
    The mesh of this process (JAX `get_mesh` :31, with one device a rank).

    Args:
        mesh_shape: axis sizes, e.g. {"data": 2} or {"data": 2, "model":
            2}; None: every rank on `data`. Its product must be the world
            size.
        device_type: "cuda" (the rank's device is cuda:LOCAL_RANK) or "cpu".
        device: the rank's device, overriding `device_type`'s choice (ranks
            that share one card).

    A process group that this call initialises uses NCCL for a CUDA
    device, gloo for the CPU; the groups of a `model` axis take the
    world's backend.
    """
    if device is None:
        local = _env_int("LOCAL_RANK") or 0
        device = (torch.device("cuda", local) if device_type == "cuda"
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass --device cpu to run on the CPU")
        torch.cuda.set_device(device)
    owned = False
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        group, backend = dist.group.WORLD, dist.get_backend()
    elif _env_int("WORLD_SIZE") is not None and _env_int("RANK") is not None:
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
        group, owned = dist.group.WORLD, True
    else:
        rank, world, group, backend = 0, 1, None, None
    try:
        _check_shape(mesh_shape, world)
    except ValueError:
        if owned:
            dist.destroy_process_group()
        raise
    model_world = int((mesh_shape or {}).get(MODEL_AXIS, 1))
    data_group = model_group = None
    if model_world > 1 and world > model_world:
        data_world = world // model_world
        # every rank makes every group, in the same order
        for m in range(model_world):
            g = dist.new_group([d * model_world + m
                                for d in range(data_world)])
            if rank % model_world == m:
                data_group = g
        for d in range(data_world):
            g = dist.new_group([d * model_world + m
                                for m in range(model_world)])
            if rank // model_world == d:
                model_group = g
    return Mesh(rank=rank, world=world, device=device, group=group,
                backend=backend, owned=owned, model_world=model_world,
                data_group=data_group, model_group=model_group)


def _check_shape(mesh_shape: Optional[Dict[str, int]], world: int) -> None:
    if not mesh_shape:
        return
    for axis, size in mesh_shape.items():
        if axis not in (DATA_AXIS, MODEL_AXIS) and size > 1:
            raise ValueError(f"mesh_shape {mesh_shape}: unknown axis "
                             f"{axis!r}")
        if int(size) < 1:
            raise ValueError(f"mesh_shape {mesh_shape}: axis {axis!r} has "
                             f"size {size}")
    n = 1
    for size in mesh_shape.values():
        n *= int(size)
    if n != world:
        hint = (" (--single_gpu asks for one rank)"
                if mesh_shape == {DATA_AXIS: 1} else "")
        raise ValueError(f"mesh_shape {mesh_shape} needs {n} ranks, the "
                         f"process group has {world}{hint}")


def batch_rows(mesh: Optional[Mesh], global_b: int) -> slice:
    """The rows of a global batch of `global_b` that this rank holds
    (JAX `batch_sharding` :52: the leading dim over `data`; the ranks of
    one model group hold the same rows)."""
    if mesh is None or not mesh.data_parallel:
        return slice(0, global_b)
    if global_b % mesh.data_world:
        raise ValueError(f"the global batch of {global_b} does not split "
                         f"over {mesh.data_world} ranks")
    local = global_b // mesh.data_world
    return slice(mesh.data_rank * local, (mesh.data_rank + 1) * local)


def _flat(tensors: List[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def broadcast_params(mesh: Optional[Mesh],
                     tensors: Iterable[torch.Tensor]) -> None:
    """Rank 0's values into `tensors` on every rank, in place (JAX
    `shard_params` :62: parameters replicated)."""
    if mesh is None or not mesh.distributed:
        return
    tensors = list(tensors)
    with torch.no_grad():
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            group = [t for t in tensors if t.dtype == dtype]
            flat = _flat(group, dtype)
            dist.broadcast(flat, src=0, group=mesh.group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def _gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The rows of every data rank concatenated in rank order (bool
    tensors travel as uint8)."""
    send = x.contiguous()
    if send.dtype == torch.bool:
        send = send.to(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(mesh.data_world)]
    dist.all_gather(parts, send, group=mesh.data_group)
    return torch.cat(parts).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0; the backward keeps the rank's rows of the
    cotangent. Every rank computes the same loss from the gathered rows,
    so that cotangent is the same on every rank and its rows of this rank
    are the whole cotangent of this rank's rows: the parameters' gradients
    are then summed over ranks (`all_reduce_grads`)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.rows = batch_rows(mesh, x.shape[0] * mesh.data_world)
        return _gather(mesh, x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[ctx.rows], None


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of `x` (equal shapes on every rank) along
    dim 0, in rank order; differentiable as `_GatherRows` says. Identity
    without a data axis."""
    if mesh is None or not mesh.data_parallel:
        return x
    if x.requires_grad:
        return _GatherRows.apply(x, mesh)
    return _gather(mesh, x)


def all_reduce_grads(mesh: Optional[Mesh],
                     grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The sum over data ranks of every gradient, by one all-reduce of a
    flat float32 buffer; returns views of that buffer under the same
    names. Identity without a data axis."""
    if mesh is None or not mesh.data_parallel:
        return grads
    names = list(grads)
    flat = _flat([grads[n] for n in names], torch.float32)
    dist.all_reduce(flat, group=mesh.data_group)
    out, offset = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[offset:offset + g.numel()].view(g.shape).to(g.dtype)
        offset += g.numel()
    return out


def all_reduce_metrics(mesh: Optional[Mesh],
                       metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The sum over data ranks of each scalar metric (one all-reduce);
    float32 0-d tensors on the same device. Identity without a data
    axis."""
    if mesh is None or not mesh.data_parallel:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[n].float().reshape(()) for n in names])
    dist.all_reduce(flat, group=mesh.data_group)
    return {n: flat[i] for i, n in enumerate(names)}


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum over data ranks of one tensor, not differentiable (a
    count)."""
    if mesh is None or not mesh.data_parallel:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.data_group)
    return x


def all_reduce_max(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over data ranks of one tensor, not
    differentiable (the longest lengths of the global batch)."""
    if mesh is None or not mesh.data_parallel:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.data_group)
    return x


def gather_objects(mesh: Optional[Mesh], obj: Any) -> List[Any]:
    """A picklable object of every data rank, in rank order (host values:
    keys and sentences)."""
    if mesh is None or not mesh.data_parallel:
        return [obj]
    out: List[Any] = [None] * mesh.data_world
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out


def broadcast_object(mesh: Optional[Mesh], obj: Any) -> Any:
    """Rank 0's object on every rank."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj if mesh.is_writer else None]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (around rank 0's writes)."""
    if mesh is None or not mesh.distributed:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def destroy(mesh: Optional[Mesh]) -> None:
    """End the process group where `get_mesh` initialised it (a group that
    the caller set up stays)."""
    if mesh is not None and mesh.owned and dist.is_initialized():
        dist.destroy_process_group()
