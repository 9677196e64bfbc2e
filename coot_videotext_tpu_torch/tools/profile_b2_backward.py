#!/usr/bin/env python3
"""
B2's backward (GenPool, ops/genpool.py) at the four calls of a
yc2_2d3d_coot train step (bf16, D 384, H 768, 2 heads, dropout 0.01), on
one CUDA card:

    python3 coot_videotext_tpu_torch/tools/profile_b2_backward.py [--root DIR]

DIR (default: the checkout that holds this file) is the repository whose
`coot_videotext_tpu_torch` is imported and whose kernels are built, so
that two checkouts can be compared in turns on one card. For each call it
prints one JSON line:
- max_rel_err: per gradient (df, dw1, db1, dw2, db2), max |kernel - plain|
  / max(1, max |plain|) against genpool_backward_plain on the same inputs;
- repeats: whether a second backward is bit-equal to the first;
- autograd_ms: CUDA events over 10 backwards through torch.autograd.grad
  (as chip_smoke.py phase 5 times them), median of 5 rounds, and each
  round's time;
- device_ms and by_kernel: the profiler's device time per backward, in
  all and by kernel;
- bound_ms: 6 * rows * (D*H + H*D/heads) flops over 989 TF/s.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

CALLS = (("clips", 832, 80), ("video context", 64, 80),
         ("paragraph", 64, 320), ("sentences", 832, 24))
D, H, HEADS, RATE, SEED = 384, 768, 2, 0.01, 20261016
PEAK_BF16 = 989e12


def events_ms(fn, iters: int = 10, rounds: int = 5):
    """Median over rounds of CUDA-event ms per call over iters calls, and
    the rounds."""
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
    return statistics.median(out), out


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
    from coot_videotext_tpu_torch.ops.genpool import (
        genpool, genpool_backward_plain)
    cuda_build.load_library()
    print(f"package {Path(cuda_build.__file__).resolve().parents[1]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = dict(device="cuda")
    dh, dho = H // HEADS, D // HEADS
    for what, s, length in CALLS:
        f = torch.randn(s, length, D, generator=gen, **dev).to(torch.bfloat16)
        lens = torch.randint(1, length + 1, (s,), generator=gen, **dev)
        mask = torch.arange(length, **dev)[None] < lens[:, None]
        params = [torch.randn(HEADS, D, dh, generator=gen, **dev) / D ** 0.5,
                  0.1 * torch.randn(HEADS, dh, generator=gen, **dev),
                  torch.randn(HEADS, dh, dho, generator=gen, **dev)
                  / dh ** 0.5,
                  0.1 * torch.randn(HEADS, dho, generator=gen, **dev)]
        leaves = [f.clone().requires_grad_()] + [
            p.clone().requires_grad_() for p in params]
        y = genpool(leaves[0], mask, *leaves[1:], "gelu", RATE, SEED)
        dout = torch.randn(s, D, generator=gen, **dev).to(torch.bfloat16)

        def backward():
            return torch.autograd.grad(y, leaves, dout, retain_graph=True)

        grads = backward()
        ref = genpool_backward_plain(f, mask, *params, "gelu", dout, RATE,
                                     SEED)
        errs = {}
        for name, a, r in zip(("df", "dw1", "db1", "dw2", "db2"), grads,
                              ref):
            a, r = a.float(), r.float()
            err = float((a - r).abs().max()) if bool(
                a.isfinite().all()) else math.inf
            errs[name] = err / max(1.0, float(r.abs().max()))
        repeats = all(torch.equal(a, b) for a, b in zip(grads, backward()))
        del grads, ref
        ms, rounds = events_ms(backward)
        split = by_kernel_ms(backward)
        rows = s * length
        bound = 6.0 * rows * (D * H + H * dho) / PEAK_BF16 * 1e3
        print(json.dumps(dict(
            call=what, pooled_rows=s, length=length, rows=rows,
            max_rel_err=errs, repeats=repeats, autograd_ms=ms,
            rounds=rounds, device_ms=sum(split.values()),
            by_kernel=split, bound_ms=bound)), flush=True)
        del f, mask, params, leaves, y, dout
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
