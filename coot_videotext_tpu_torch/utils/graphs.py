"""
Programs captured as CUDA graphs: the port's counterpart of what the JAX
package compiles with jax.jit and keeps in a jit cache (the caption
decodes' token loops, the beam token step and memory rebuild, the
retrieval and caption eval steps; tasks/retrieval/steps.py `StepGraph`
captures the train group's step with `capture` too).

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

A `GraphCache` holds the programs of one module by key, as JAX's jit
cache does: the program's name, its static flags and the shapes and
dtypes of its inputs (`signature`). The programs replay with the live
parameters: in-place updates keep them valid (load_state_dict, the EMA
swap's copy_, the optimizers' _foreach_* updates), and the cache drops
every program when a parameter or buffer no longer sits at the address
the programs were captured with (a parameter replaced, as the tensor
parallel re-placement does, or the module moved). Its programs share one
memory pool: they never run at the same time, and a program's outputs
stay valid until the next run of any program of the cache, so a caller
copies or reads them before that.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

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


class Program:
    """`body(inputs) -> outputs` over static copies of `inputs` (a pytree,
    usually a dict, of tensors on one device): captured at its first call
    on the card, run eagerly on the CPU."""

    def __init__(self, body: Callable[[Any], Any], inputs,
                 pool=None) -> None:
        self.body = body
        self.inputs = tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format),
            inputs)
        self.device = tree_flatten(inputs)[0][0].device
        self.pool = pool
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
        on the card are the graph's static outputs."""
        if inputs:
            self.load(inputs)
        if self.device.type != "cuda":
            self.outputs = self.body(self.inputs)
            return self.outputs
        if self.graph is None:
            self.graph, self.outputs = capture(
                lambda: self.body(self.inputs),
                torch.cuda.Stream(self.device), self.pool)
        self.graph.replay()
        return self.outputs


class GraphCache:
    """The programs of `module` by key, valid while its parameters and
    buffers keep their addresses (see the module docstring)."""

    def __init__(self, module: torch.nn.Module) -> None:
        self.module = module
        self.programs: Dict[Hashable, Program] = {}
        self.pool = None
        self.addresses: Tuple[int, ...] = ()
        self.captures = 0  # programs built since the cache was made

    def check(self) -> "GraphCache":
        """Drops every program if a parameter or buffer moved; call once
        per top-level call, before `get`."""
        addresses = tuple(t.data_ptr() for t in itertools.chain(
            self.module.parameters(), self.module.buffers()))
        if addresses != self.addresses:
            self.programs.clear()
            self.pool = None
            self.addresses = addresses
        return self

    def get(self, key: Hashable, body: Callable[[Any], Any],
            inputs) -> Program:
        """The program of `key`, built on `body` and the example `inputs`
        the first time."""
        program = self.programs.get(key)
        if program is None:
            device = tree_flatten(inputs)[0][0].device
            if self.pool is None and device.type == "cuda":
                self.pool = torch.cuda.graph_pool_handle()
            program = Program(body, inputs, self.pool)
            self.programs[key] = program
            self.captures += 1
        return program


def cache_of(module: torch.nn.Module) -> GraphCache:
    """The module's graph cache (made at the first call), checked."""
    cache = module.__dict__.get("_graph_cache")
    if cache is None:
        cache = module.__dict__["_graph_cache"] = GraphCache(module)
    return cache.check()
