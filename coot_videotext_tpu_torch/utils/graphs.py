"""
Programs captured as CUDA graphs: the port's counterpart of what the JAX
package compiles with jax.jit and keeps in a jit cache (the caption
decodes' token loops, the beam token step and memory rebuild, the
retrieval and caption eval steps, the retrieval group's step and the
caption train steps).

`capture` runs a function once eagerly on a side stream, after the work
already queued on the current stream, and then captures it into a new
graph on the same stream. The eager run sets up what a capture cannot:
cuBLAS handles and workspaces, the kernel library, NCCL communicators
(their collectives are captured after a warm call). A capture runs
nothing, so the kernel wrappers' launch counts (ops/cuda_build.py) rise
at the eager run and once more at the capture; a replay runs no Python
and counts nothing.

A `Program` is a body over a pytree of named static tensors. On the card
its first call captures the body (`capture`) and every call copies its new
inputs into the static buffers and replays the graph; on the CPU the same
body runs eagerly on the same static buffers, so the tests reach the
graph path's logic. A body reads only its static inputs, the module's
parameters and buffers and what it closes over at its key; it may write
its static inputs in place (the beam token step writes its ids at
`dec_idx`) as long as a second run writes the same values, since the
capture's eager run and the first replay both run it. Nothing in a body
may read a value back to the host.

A `GraphCache` holds programs by key, as JAX's jit cache does: the
program's name, its static flags and the shapes and dtypes of its inputs
(`signature`); `cache_of` gives each module one. The programs replay with
the live parameters: in-place updates keep them valid (load_state_dict, the EMA
swap's copy_, the optimizers' _foreach_* updates), and the cache drops
every program when a parameter or buffer no longer sits at the address
the programs were captured with (a parameter replaced, as the tensor
parallel re-placement does, or the module moved). Its programs share one
memory pool: they never run at the same time, and a program's outputs
stay valid until the next run of any program of the cache, so a caller
copies or reads them before that.

A stateful program (`Program(..., stateful=True)`: a train step, which
moves its train state) is not run twice at its first call: the capture's
eager run is that call, whose outputs it returns, and the capture that
follows records the body without running it; every later call is one
replay. A train state's cache (`programs_of`) checks the addresses of
everything its programs read, the optimizer's and the EMA's tensors as
well as the parameters'.

Each cache counts its programs' calls (`counts`: "runs", every call
through a program; "replays", the graph replays among them), so that a
caller can say how its steps ran from what ran (`mode`).

A program keeps its body only until its capture: after it the graph
replays without Python, and no reference cycle through a module's cache
(module, cache, program, body, module) keeps a dead model's graphs and
their memory pool alive until a garbage collection. Every live cache is
registered, with no strong reference from the registry or the cache to
what it serves, so that
`release_all` can drop every captured graph of the process (each graph
reset, then a device synchronisation) before the process group ends
(parallel/mesh.py `destroy`): a graph that holds NCCL collectives keeps
NCCL's communicator from being destroyed while it lives.
"""

from __future__ import annotations

import itertools
import weakref
from collections import Counter
from typing import (Any, Callable, Dict, Hashable, Iterable, Optional,
                    Tuple)

import torch
from torch.utils._pytree import tree_flatten, tree_map


def capture(run: Callable[[], Any], stream: torch.cuda.Stream,
            pool=None) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """Runs `run()` eagerly on `stream`, then captures it on the same
    stream into a new graph (memory from `pool`, a
    torch.cuda.graph_pool_handle(), or the graph's own). Returns (the
    graph, what the captured call returned). A failed capture raises. Only
    this thread's calls are checked during the capture, so a producer
    thread may copy batches on its own stream meanwhile."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        run()
    current.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = run()
    return graph, out


def signature(tree) -> Tuple:
    """The shapes, dtypes and devices of a pytree's tensors, in order."""
    leaves, _ = tree_flatten(tree)
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


# every live GraphCache
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def release_all() -> int:
    """Drops the graphs of every live cache, then waits for the devices:
    nothing captured survives it. Returns the graphs dropped."""
    dropped = sum(cache.release() for cache in list(_LIVE))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return dropped


class Program:
    """`body(inputs) -> outputs` over static copies of `inputs` (a pytree,
    usually a dict, of tensors on one device): captured at its first call
    on the card, run eagerly on the CPU. `stateful`: the first call on the
    card runs the body once (the capture's eager run, whose outputs it
    returns) and records it without running it again. `counts` (its
    cache's) gains a "runs" a call and a "replays" a graph replay."""

    def __init__(self, body: Callable[[Any], Any], inputs,
                 pool=None, stateful: bool = False,
                 counts: Optional[Counter] = None) -> None:
        self.body = body
        self.inputs = tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format),
            inputs)
        self.device = tree_flatten(inputs)[0][0].device
        self.pool = pool
        self.stateful = stateful
        self.counts = Counter() if counts is None else counts
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None

    def load(self, inputs: Dict[str, Any]) -> None:
        """Copies each entry of `inputs` into the static buffer of that
        name (same shapes)."""
        for name, value in inputs.items():
            dst, _ = tree_flatten(self.inputs[name])
            src, _ = tree_flatten(value)
            if [d.shape for d in dst] != [s.shape for s in src]:
                raise ValueError(f"input {name!r}: shapes "
                                 f"{[tuple(s.shape) for s in src]} against "
                                 f"the static {[tuple(d.shape) for d in dst]}")
            for d, s in zip(dst, src):
                d.copy_(s, non_blocking=True)

    def __call__(self, inputs: Optional[Dict[str, Any]] = None):
        """Loads `inputs` (if any) and runs the body: its outputs, which
        on the card are the graph's static outputs (at a stateful
        program's first call, its eager run's)."""
        if inputs:
            self.load(inputs)
        self.counts["runs"] += 1
        if self.device.type != "cuda":
            self.outputs = self.body(self.inputs)
            return self.outputs
        if self.graph is None:
            if self.body is None:
                raise RuntimeError("the program was released")
            runs = []

            def run():
                runs.append(self.body(self.inputs))
                return runs[-1]
            self.graph, self.outputs = capture(
                run, torch.cuda.Stream(self.device), self.pool)
            # the graph needs no Python: dropping the body (which holds
            # the model) leaves no reference cycle through the cache
            self.body = None
            if self.stateful:
                return runs[0]
        self.graph.replay()
        self.counts["replays"] += 1
        return self.outputs

    def release(self) -> int:
        """Drops the graph (reset at once) and its outputs; returns 1 if
        there was one. A released program does not run again."""
        graph, self.graph, self.outputs = self.graph, None, None
        if graph is None:
            return 0
        graph.reset()
        return 1


class GraphCache:
    """Programs by key, valid while the tensors that `tensors()` yields
    keep their addresses (see the module docstring): the module's
    parameters and buffers (`cache_of`), or a train state's tensors."""

    def __init__(self, tensors: Callable[[], Iterable[torch.Tensor]]
                 ) -> None:
        self.tensors = tensors
        self.programs: Dict[Hashable, Program] = {}
        self.pool = None
        self.addresses: Tuple[int, ...] = ()
        self.captures = 0  # programs built since the cache was made
        self.counts: Counter = Counter()  # its programs' runs and replays
        _LIVE.add(self)

    def check(self) -> "GraphCache":
        """Drops every program if a tensor moved; call once per top-level
        call, before `get`."""
        addresses = tuple(t.data_ptr() for t in self.tensors())
        if addresses != self.addresses:
            self.release()
            self.addresses = addresses
        return self

    def get(self, key: Hashable, body: Callable[[Any], Any],
            inputs, stateful: bool = False) -> Program:
        """The program of `key`, built on `body` and the example `inputs`
        the first time."""
        program = self.programs.get(key)
        if program is None:
            device = tree_flatten(inputs)[0][0].device
            if self.pool is None and device.type == "cuda":
                self.pool = torch.cuda.graph_pool_handle()
            program = Program(body, inputs, self.pool, stateful,
                              self.counts)
            self.programs[key] = program
            self.captures += 1
        return program

    def release(self) -> int:
        """Drops every program and the pool; returns the graphs dropped."""
        dropped = sum(p.release() for p in self.programs.values())
        self.programs.clear()
        self.pool = None
        return dropped


def _tensors_of(ref: "weakref.ref", tensors: Callable[[Any], Iterable]
                ) -> Iterable[torch.Tensor]:
    owner = ref()
    return () if owner is None else tensors(owner)


def _module_tensors(module: torch.nn.Module) -> Iterable[torch.Tensor]:
    return itertools.chain(module.parameters(), module.buffers())


def cache_of(module: torch.nn.Module) -> GraphCache:
    """The module's graph cache (made at the first call), checked."""
    cache = module.__dict__.get("_graph_cache")
    if cache is None:
        ref = weakref.ref(module)
        cache = module.__dict__["_graph_cache"] = GraphCache(
            lambda: _tensors_of(ref, _module_tensors))
    return cache.check()


def programs_of(state, tensors: Callable[[Any], Iterable[torch.Tensor]]
                ) -> GraphCache:
    """A train state's cache of captured steps, its `programs` field (made
    at the first call), checked: valid while every tensor of
    `tensors(state)` keeps its address. The cache holds the state
    weakly."""
    if state.programs is None:
        ref = weakref.ref(state)
        state.programs = GraphCache(lambda: _tensors_of(ref, tensors))
    return state.programs.check()


def runs_of(module: torch.nn.Module) -> int:
    """The program runs of the module's graph cache (0 before it has
    one)."""
    cache = module.__dict__.get("_graph_cache")
    return 0 if cache is None else cache.counts["runs"]


def mode(runs: int, calls: int, device: torch.device) -> str:
    """How `calls` calls on `device` ran, `runs` of them through a
    program (a cache's `counts`): "CUDA graph", "program body, eagerly on
    the cpu", "eager" (none), or "R of N through programs"."""
    if runs == 0:
        return "eager"
    if runs != calls:
        return f"{runs} of {calls} through programs"
    return ("CUDA graph" if device.type == "cuda"
            else "program body, eagerly on the cpu")
