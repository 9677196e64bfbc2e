#!/usr/bin/env python3
"""
Host and device time of B1's backward (the fused input FC,
ops/input_fc.py) at the four calls of a yc2_2d3d_coot train step (bf16,
dout 384), on one CUDA card:

    python3 coot_videotext_tpu_torch/tools/profile_b1_backward.py [--root DIR]

DIR (default: the checkout that holds this file) is the repository whose
`coot_videotext_tpu_torch` is imported and whose kernels are built, so
that two checkouts can be compared in turns on one card. For each call it
prints one JSON line:
- autograd_ms: CUDA events over 10 backwards through torch.autograd.grad
  (as chip_smoke.py phase 5 times them), median of 5 rounds;
- device_ms and by_kernel: the profiler's device time per backward, in
  all and by kernel;
- grad_host_us: host microseconds per torch.autograd.grad call, the
  launches queued and not waited for (median of 5 rounds of 50 calls);
- wrapper_host_us: the same for a direct call of the autograd Function's
  backward on the graph's node (`_InputFC.backward(y.grad_fn, dy)`),
  without autograd's engine;
- engine_host_us: the same for torch.autograd.grad through a Function
  with the same inputs whose backward only returns tensors made
  beforehand: the engine's own cost for this graph.
After the lines of the smallest call (the video global net's) it prints
the top of a cProfile of 200 direct wrapper calls (by own time) and the
profiler's host-side table of 20 torch.autograd.grad calls (by self CPU
time).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

CALLS = (("clips", 66560, 4096), ("video global", 5120, 4096),
         ("paragraph", 20480, 1536), ("sentences", 19968, 1536))
DOUT = 384


def host_us(fn, calls: int = 50, rounds: int = 5) -> float:
    """Median over rounds of host microseconds per call of fn (launches
    queued; the device is waited for between rounds only)."""
    import torch
    out = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def events_ms(fn, iters: int = 10, rounds: int = 5) -> float:
    """Median over rounds of CUDA-event ms per call over iters calls."""
    import torch
    out = []
    for _ in range(rounds):
        fn()
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def by_kernel_ms(fn, calls: int = 20) -> dict:
    """The profiler's device ms per call of fn, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if str(e.device_type).endswith("CUDA") and dev > 0:
            name = e.key.replace("(anonymous namespace)::", "").split(
                "(")[0].split("::")[-1]
            per_call = dev / e.count * max(1, round(e.count / calls))
            out[name] = out.get(name, 0.0) + per_call / 1e3
    return out


def host_tables(backward, wrapper) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(200):
        wrapper()
    prof.disable()
    torch.cuda.synchronize()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
    print("cProfile of 200 direct wrapper calls, by own time:")
    print("\n".join(line for line in text.getvalue().splitlines()
                    if line.strip()))
    with profile(activities=[ProfilerActivity.CPU]) as tprof:
        for _ in range(20):
            backward()
        torch.cuda.synchronize()
    print("profiler, host side of 20 torch.autograd.grad calls:")
    print(tprof.key_averages().table(sort_by="self_cpu_time_total",
                                     row_limit=16, max_name_column_width=48))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[2])
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.ops.input_fc import _InputFC, fused_input_fc
    cuda_build.load_library()
    print(f"package {Path(cuda_build.__file__).resolve().parents[1]}")

    class _Ready(torch.autograd.Function):
        """B1's inputs and output, a backward that only returns `grads`."""

        @staticmethod
        def forward(ctx, x, gain, bias, weight, b, grads):
            ctx.grads = grads
            return torch.empty(x.shape[0], weight.shape[0], dtype=x.dtype,
                               device=x.device)

        @staticmethod
        def backward(ctx, dy):
            return (None, *ctx.grads, None)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for what, s, din in CALLS:
        dev = dict(device="cuda")
        x = (2 * torch.randn(s, din, generator=gen, **dev) + 0.5).to(
            torch.bfloat16)
        params = [1 + 0.1 * torch.randn(din, generator=gen, **dev),
                  0.1 * torch.randn(din, generator=gen, **dev),
                  torch.randn(DOUT, din, generator=gen, **dev) / din ** 0.5,
                  0.1 * torch.randn(DOUT, generator=gen, **dev)]
        leaves = [p.requires_grad_() for p in params]
        y = fused_input_fc(x, *leaves, 1e-6, "gelu")
        dy = torch.randn(s, DOUT, generator=gen, **dev).to(torch.bfloat16)
        node = y.grad_fn

        def backward():
            return torch.autograd.grad(y, leaves, dy, retain_graph=True)

        def wrapper():
            return _InputFC.backward(node, dy)

        grads = tuple(torch.zeros_like(p) for p in params)
        y_ready = _Ready.apply(x, *leaves, grads)
        kernels = by_kernel_ms(backward)
        row = dict(
            call=what, rows=s, din=din, dout=DOUT,
            autograd_ms=events_ms(backward),
            device_ms=sum(kernels.values()), by_kernel=kernels,
            grad_host_us=host_us(backward), wrapper_host_us=host_us(wrapper),
            engine_host_us=host_us(lambda: torch.autograd.grad(
                y_ready, leaves, dy, retain_graph=True)))
        print(json.dumps(row), flush=True)
        if what == "video global":
            host_tables(backward, wrapper)
        del x, params, leaves, y, dy, node, grads, y_ready
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
