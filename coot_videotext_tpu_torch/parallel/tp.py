"""
Tensor parallelism over the `model` axis of the mesh (parallel/mesh.py):
the counterpart of coot_videotext_tpu/parallel/tp.py.

JAX shards a parameter by rules on its path (`DEFAULT_TP_RULES` :26-39,
copied here as they are) and GSPMD computes the same global function with
whatever collectives the placement needs. Here each rank is a process, so
the layers that hold a sharded weight run Megatron-style with explicit
collectives over the rank's model group:

    - column-parallel (P(None, model) on the JAX kernel (din, dout): dim 0
      of the torch weight (dout, din)): the rank's output columns from the
      whole input, which passes through `copy_to_model` ("f": identity
      forward, all-reduce of dx backward); where no row-parallel layer
      follows, `gather_from_model` joins the columns (its backward keeps
      the rank's columns: everything downstream is replicated).
    - row-parallel (P(model, None): dim 1 of the torch weight): the rank's
      input columns times its rows; `reduce_from_model` ("g") sums the
      partial products, then the bias is added once.
    - a head-sharded attention (models/attention.py, models/caption/
      bert.py) runs its rank's heads: q, k, v column-parallel, the output
      projection row-parallel, or the context gathered where there is none.
    - where a layer cannot run its shard (heads % M != 0, a rule on a layer
      without a parallel form) its Linear gathers the whole weight on each
      call and computes what one process computes.
The biases stay whole, as JAX keeps them (its rules name kernels only):
each rank uses its slice of a column-parallel bias, so the gradient of the
whole bias is non-zero only there; those gradients, and B1's LayerNorm
gain and bias (the kernel's dgain and dbias are sums over the rank's
columns), are summed over the model group before the optimizer
(`Layout.reduce_partial`), so every rank of the group holds the same whole
tensors. The global norm counts a sharded gradient's squares summed over
the model group and a replicated one once (`Layout.sum_over_model`).

`infer_param_shardings` applies the rules to the JAX path of each
parameter (utils/param_bridge.py `coot_jax_paths`, `mart_jax_paths`) and
keeps JAX's divisibility test; `shard_model_for_tp` (JAX
`shard_state_for_tp` :76) keeps the rank's slice of each sharded parameter,
of its optimizer moments and of its EMA shadow, and places the layers.
Checkpoints hold whole tensors (`Layout.gather`, `Layout.localize`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from coot_videotext_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from coot_videotext_tpu_torch.utils.param_bridge import (
    coot_jax_paths, mart_jax_paths)

Spec = Tuple[Optional[str], ...]

# (param-path regex, spec of the JAX kernel): column-parallel shards the
# OUTPUT feature dim (last), row-parallel the INPUT dim (first)
DEFAULT_TP_RULES: List[Tuple[str, Spec]] = [
    # attention projections (COOT + BERT naming)
    (r"(query|key|value)(_projection)?/kernel", (None, MODEL_AXIS)),
    (r"final_projection/kernel", (MODEL_AXIS, None)),
    (r"attention/self/(query|key|value)/kernel", (None, MODEL_AXIS)),
    (r"attention/output/dense/kernel", (MODEL_AXIS, None)),
    # feed-forward up/down
    (r"(pointwise|hidden_intermediate|intermediate)[^/]*/dense/kernel",
     (None, MODEL_AXIS)),
    (r"linear1/kernel", (None, MODEL_AXIS)),
    (r"linear2/kernel", (MODEL_AXIS, None)),
    # big input projections (e.g. COOT input FC over 4096-d features)
    (r"input_fc/.*kernel", (None, MODEL_AXIS)),
]


def _replicated(model: nn.Module) -> bool:
    """Whether `model` is a caption model that runs replicated under a
    `model` axis, as JAX runs it: the TransformerXL (none of its kernels
    matches a rule), the untied and joint single-sentence models and the
    MTransformer (JAX's caption trainer and single-sentence step pass no
    state shardings, tasks/caption/trainer.py:148-164, steps.py:167-204)."""
    from coot_videotext_tpu_torch.models.caption.mart import (
        NonRecurTransformer)
    from coot_videotext_tpu_torch.models.caption.mtransformer import (
        MTransformer)
    from coot_videotext_tpu_torch.models.caption.untied import (
        NonRecurTransformerUntied)
    from coot_videotext_tpu_torch.models.caption.xl import TransformerXL
    return isinstance(model, (TransformerXL, NonRecurTransformer,
                              NonRecurTransformerUntied, MTransformer))


def jax_paths(model: nn.Module) -> Dict[str, str]:
    """{parameter name: JAX path} of a model that tensor parallelism
    covers: the retrieval model and recurrent MART."""
    from coot_videotext_tpu_torch.models.caption.mart import (
        RecursiveTransformer)
    from coot_videotext_tpu_torch.models.retrieval import RetrievalModel
    if isinstance(model, RetrievalModel):
        return coot_jax_paths(model)
    if isinstance(model, RecursiveTransformer):
        return mart_jax_paths(model)
    raise NotImplementedError(
        f"tensor parallelism (a `model` mesh axis) shards the retrieval "
        f"model and recurrent MART, not {type(model).__name__}")


def infer_param_shardings(model: nn.Module, model_world: int,
                          rules: Optional[List[Tuple[str, Spec]]] = None,
                          paths: Optional[Dict[str, str]] = None
                          ) -> Dict[str, Optional[int]]:
    """
    {parameter name: the torch dim sharded over the `model` axis, or None}
    (JAX `infer_param_shardings` :42): the first rule that matches the
    parameter's JAX path, has its rank and divides its dims by
    `model_world` shards it; a kernel is the transposed torch weight.
    Nothing is sharded at model_world 1.
    """
    if rules is None:
        rules = DEFAULT_TP_RULES
    if paths is None:
        paths = jax_paths(model)
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out: Dict[str, Optional[int]] = {}
    for name, param in model.named_parameters():
        out[name] = None
        if model_world <= 1:
            continue
        path = paths[name]
        kernel = path.rsplit("/", 1)[-1] == "kernel" and param.dim() == 2
        shape = tuple(param.shape)[::-1] if kernel else tuple(param.shape)
        for pat, spec in compiled:
            if not pat.search(path) or len(spec) != len(shape):
                continue
            if all(ax is None or shape[i] % model_world == 0
                   for i, ax in enumerate(spec)):
                jdim = spec.index(MODEL_AXIS)
                out[name] = len(shape) - 1 - jdim if kernel else jdim
                break
    return out


# ---------- the model group's collectives ----------

class _Copy(torch.autograd.Function):
    """Megatron's "f": identity forward; the backward sums dx over the
    model group (each rank's column-parallel layers give a part of it)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Megatron's "g": the sum over the model group forward (partial
    products of a row-parallel layer); identity backward."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.model_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.model_world)]
    dist.all_gather(parts, x, group=mesh.model_group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    """The model group's shards joined along `dim` in model-rank order;
    the backward keeps the rank's shard of the cotangent (the gathered
    tensor feeds replicated computation, equal on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        return _all_gather(x.contiguous(), mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.model_rank * ctx.size
        return (grad.narrow(ctx.dim, start, ctx.size).contiguous(), None,
                None)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Copy.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Reduce.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh,
                      dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, mesh, dim % x.dim())


def copy_inputs(mesh: Mesh, *inputs: torch.Tensor) -> List[torch.Tensor]:
    """`copy_to_model` of each distinct tensor of `inputs` (by identity),
    once: one all-reduce of dx for a tensor that feeds q, k and v."""
    seen: Dict[int, torch.Tensor] = {}
    out = []
    for x in inputs:
        if id(x) not in seen:
            seen[id(x)] = copy_to_model(x, mesh)
        out.append(seen[id(x)])
    return out


def shard_slice(mesh: Mesh, size: int) -> Tuple[int, int]:
    """(start, length) of the rank's shard of a dim of `size`."""
    n = size // mesh.model_world
    return mesh.model_rank * n, n


# ---------- placed Linear layers ----------

@dataclasses.dataclass(frozen=True)
class LinearPlacement:
    """How a Linear (models/layers.py) with a sharded weight runs: "column"
    (its rows of the weight: the rank's output columns, its slice of the
    bias), "row" (its columns: partial products summed over the model
    group, then the whole bias) or "gather" (the whole weight gathered on
    each call, the whole bias; `dim` the weight's sharded dim)."""
    kind: str
    mesh: Mesh
    dim: int

    def linear(self, module: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        w, b = module.weight, module.bias
        dt = x.dtype
        if self.kind == "column":
            if b is not None:
                b = b.narrow(0, *shard_slice(self.mesh, b.shape[0]))
            return F.linear(x, w.to(dt), None if b is None else b.to(dt))
        if self.kind == "row":
            y = reduce_from_model(F.linear(x, w.to(dt)), self.mesh)
            return y if b is None else y + b.to(dt)
        w = gather_from_model(w, self.mesh, self.dim)
        return F.linear(x, w.to(dt), None if b is None else b.to(dt))


def place_linear(module: nn.Linear, kind: str, mesh: Mesh,
                 dim: int) -> Set[str]:
    """Places `module`; returns its partial gradients (the bias of a
    column-parallel weight: each rank adds its slice)."""
    if not hasattr(module, "tp"):
        raise NotImplementedError(
            f"{type(module).__name__} holds a weight that the rules shard "
            "but has no tensor-parallel form")
    module.tp = LinearPlacement(kind, mesh, dim)
    return {"bias"} if kind == "column" and module.bias is not None else set()


# ---------- the layout ----------

@dataclasses.dataclass
class Layout:
    """The model's sharding under `mesh`: `shards` {parameter name: torch
    dim} of the parameters each rank holds a slice of; `partial` the
    parameters whose gradient is a part summed over the model group."""
    mesh: Mesh
    shards: Dict[str, int]
    partial: Tuple[str, ...]
    _masks: Dict[Tuple[str, ...], torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """The rank's slice of `whole` where `name` is sharded."""
        dim = self.shards.get(name)
        if dim is None:
            return whole
        return whole.narrow(dim, *shard_slice(self.mesh, whole.shape[dim]))

    def localize(self, tensors: Dict[str, torch.Tensor],
                 prefix: str = "") -> Dict[str, torch.Tensor]:
        """`local` of every entry (names `prefix` + key), as contiguous
        copies."""
        return {k: self.local(prefix + k, v).contiguous()
                if prefix + k in self.shards else v
                for k, v in tensors.items()}

    def gather(self, tensors: Dict[str, torch.Tensor],
               prefix: str = "") -> Dict[str, torch.Tensor]:
        """The whole tensors of every sharded entry (an all-gather over the
        model group each, in the dict's order: every rank of the group
        calls it with the same keys); the others as they are."""
        out = {}
        for k, v in tensors.items():
            dim = self.shards.get(prefix + k)
            if dim is None:
                out[k] = v
                continue
            device = self.mesh.device
            whole = _all_gather(v.detach().to(device).contiguous(),
                                self.mesh, dim)
            out[k] = whole.to(v.device)
        return out

    def reduce_partial(self, grads: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The partial gradients summed over the model group (one
        all-reduce of a flat float32 buffer), the others as they are."""
        names = [n for n in self.partial if n in grads]
        if not names:
            return grads
        flat = torch.cat([grads[n].reshape(-1).float() for n in names])
        dist.all_reduce(flat, group=self.mesh.model_group)
        out = dict(grads)
        offset = 0
        for n in names:
            g = grads[n]
            out[n] = flat[offset:offset + g.numel()].view(g.shape).to(
                g.dtype)
            offset += g.numel()
        return out

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the model group (not differentiable)."""
        x = x.detach().clone()
        dist.all_reduce(x, group=self.mesh.model_group)
        return x

    def sharded_mask(self, names: List[str],
                     device: torch.device) -> torch.Tensor:
        """bool (len(names),) on `device`: which of `names` are sharded;
        made once per list, so that a step captured as a CUDA graph
        copies nothing from the host."""
        key = tuple(names)
        if key not in self._masks:
            self._masks[key] = torch.tensor(
                [n in self.shards for n in names], dtype=torch.bool,
                device=device)
        return self._masks[key]


def _owned_shards(shards: Dict[str, int], prefix: str) -> Dict[str, int]:
    return {n[len(prefix):]: d for n, d in shards.items()
            if n.startswith(prefix)}


def shard_model_for_tp(model: nn.Module, optimizer, ema,
                       mesh: Mesh,
                       rules: Optional[List[Tuple[str, Spec]]] = None
                       ) -> Optional[Layout]:
    """
    The counterpart of JAX `shard_state_for_tp` :76: keeps the rank's slice
    of every parameter that the rules shard (in place: the Parameter
    objects stay, so the optimizer and the EMA keep their references),
    slices the optimizer's moments (`optimizer`, or None) and the EMA
    shadow (`ema`, or None) alike, and places the layers. Scalars (the
    step count, the lr) and the replicated tensors stay as they are. The
    model's parameters must be whole and equal on every rank of the group.
    Returns the layout (None without a `model` axis: nothing changes). The
    TransformerXL, the untied and joint models and the MTransformer get a
    layout that shards nothing (`_replicated`): each model group repeats
    its data rank's step.
    """
    if not mesh.tensor_parallel:
        return None
    if _replicated(model):
        return Layout(mesh, {}, ())
    paths = jax_paths(model)
    shards = {n: d for n, d in infer_param_shardings(
        model, mesh.model_world, rules, paths).items() if d is not None}
    claimed: Set[str] = set()
    partial: Set[str] = set()
    modules = dict(model.named_modules())
    # the layers with a parallel form place themselves (outer first)
    for prefix, module in modules.items():
        place = getattr(module, "place_tp", None)
        if place is None:
            continue
        base = prefix + "." if prefix else ""
        owned = {n: d for n, d in _owned_shards(shards, base).items()
                 if base + n not in claimed}
        if not owned:
            continue
        took, parts = place(mesh, owned)
        claimed.update(base + n for n in took)
        partial.update(base + n for n in parts)
    # every other sharded weight: its Linear gathers the whole weight
    for name, dim in shards.items():
        if name in claimed:
            continue
        owner, leaf = name.rsplit(".", 1)
        if leaf != "weight":
            raise NotImplementedError(f"{name}: sharded, but not a weight")
        parts = place_linear(modules[owner], "gather", mesh, dim)
        partial.update(f"{owner}.{n}" for n in parts)
    layout = Layout(mesh, shards,
                    tuple(n for n, _ in model.named_parameters()
                          if n in partial))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name in shards:
            p = params[name]
            p.data = layout.local(name, p.data).contiguous()
            if optimizer is not None:
                for moments in (optimizer.mu, optimizer.nu):
                    moments[name] = layout.local(name,
                                                 moments[name]).contiguous()
            if ema is not None:
                ema.shadow[name] = layout.local(name,
                                                ema.shadow[name]).contiguous()
    return layout
