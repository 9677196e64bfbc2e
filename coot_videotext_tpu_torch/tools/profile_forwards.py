#!/usr/bin/env python3
"""
B2's forward (GenPool, ops/genpool.py) at the four calls and B3's forward
(masked attention, ops/attention.py) at the six distinct shapes of a
yc2_2d3d_coot train step (bf16, dropout 0.01; B2 at D 384, H 768, 2 heads;
B3 at d_head 48, 8 heads), on one CUDA card:

    python3 coot_videotext_tpu_torch/tools/profile_forwards.py [--root DIR]

DIR (default: the checkout that holds this file) is the repository whose
`coot_videotext_tpu_torch` is imported and whose kernels are built, so
that two checkouts can be compared in turns on one card. Each call runs
twice: "train" (inputs that need a gradient, so the forward also writes
its stats for the backward) and "eval" (inference mode, no stats). For
each it prints one JSON line:
- max_rel_err: max |kernel - plain| / max(1, max |plain|) against the
  plain version on the same inputs, and whether a second call repeats
  the first bit for bit;
- ms: CUDA events over 10 calls, median of 5 rounds, and each round;
- device_ms and by_kernel: the profiler's device time per call, in all
  and by kernel (B2's tile pass and pooling pass apart);
- bound_ms and bound_by: B2 2 * rows * (D*H + H*D/heads) flops over 989
  TF/s against f, the weights and out; B3 the bytes of q, k, v, o and the
  mask over 3.35 TB/s against 4 * N * Lq * Lk * 48 flops;
- B3 only: sdpa_ms and sdpa_device_ms, torch.nn.functional.
  scaled_dot_product_attention on the same inputs with the key mask as an
  additive bf16 mask and the same dropout rate (a yardstick; the port
  never calls it), timed in turns with the kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys
from pathlib import Path

# (call, pooled rows, L) of B2; (call, cells, Lq, Lk) of B3
B2_CALLS = (("clips", 832, 80), ("video context", 64, 80),
            ("paragraph", 64, 320), ("sentences", 832, 24))
B3_CALLS = (("clips", 6656, 80, 80), ("video context", 512, 80, 80),
            ("paragraph", 512, 320, 320), ("sentences", 6656, 24, 24),
            ("global", 512, 16, 16), ("cross", 512, 1, 16))
D, H, HEADS, DH, RATE, SEED = 384, 768, 2, 48, 0.01, 20261016
PEAK_BF16, HBM_BYTES_PER_S = 989e12, 3.35e12


def seed_arg(value: int):
    """The kernels' seed argument as the loaded checkout takes it: since
    the seeds moved to the device, a philox.Seed (a seed state of `value`
    on the card, call 0); before, the value itself."""
    from coot_videotext_tpu_torch.ops import philox
    if hasattr(philox, "Seed"):
        return philox.Seed(philox.seed_state(value, "cuda"), 0)
    return value


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


def rel_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        return math.inf
    return float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measure(kernel, plain, mode: str) -> dict:
    """Error against the plain version, a bit-for-bit repeat, event ms
    and the profiler's device ms by kernel of `kernel` in `mode` ("eval":
    inference mode)."""
    import torch
    ctx = (torch.inference_mode if mode == "eval"
           else contextlib.nullcontext)
    with ctx():
        out = kernel()
        with torch.inference_mode():
            err = rel_err(out, plain())
        repeats = torch.equal(out.detach(), kernel().detach())
        ms, rounds = events_ms(kernel)
        split = by_kernel_ms(kernel)
    return dict(mode=mode, max_rel_err=err, repeats=repeats, ms=ms,
                rounds=rounds, device_ms=sum(split.values()),
                by_kernel=split)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[2])
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_plain)
    from coot_videotext_tpu_torch.ops.genpool import genpool, genpool_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.load_library()
    print(f"package {Path(cuda_build.__file__).resolve().parents[1]}")
    seed = seed_arg(SEED)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = dict(device="cuda")
    bf = torch.bfloat16
    dh, dho = H // HEADS, D // HEADS
    weights = 2 * D * H + 2 * H * dho + 4 * (H + D)
    for what, s, length in B2_CALLS:
        f = torch.randn(s, length, D, generator=gen, **dev).to(bf)
        lens = torch.randint(1, length + 1, (s,), generator=gen, **dev)
        mask = torch.arange(length, **dev)[None] < lens[:, None]
        params = [torch.randn(HEADS, D, dh, generator=gen, **dev) / D ** 0.5,
                  0.1 * torch.randn(HEADS, dh, generator=gen, **dev),
                  torch.randn(HEADS, dh, dho, generator=gen, **dev)
                  / dh ** 0.5,
                  0.1 * torch.randn(HEADS, dho, generator=gen, **dev)]
        leaves = [p.clone().requires_grad_() for p in params]
        rows = s * length
        bms, by = bound(2 * rows * D + rows + weights + 2 * s * D,
                        2.0 * rows * (D * H + H * dho))
        for mode, ps in (("train", leaves), ("eval", params)):
            line = measure(
                lambda: genpool(f, mask, *ps, "gelu", RATE, seed),
                lambda: genpool_plain(f, mask, *params, "gelu", RATE, seed),
                mode)
            print(json.dumps(dict(kernel="B2 forward", call=what,
                                  pooled_rows=s, length=length, rows=rows,
                                  **line, bound_ms=bms, bound_by=by)),
                  flush=True)
        del f, mask, params, leaves
        torch.cuda.empty_cache()
    for what, n, lq, lk in B3_CALLS:
        b = n // 8
        q = torch.randn(n, lq, DH, generator=gen, **dev).to(bf)
        k = torch.randn(n, lk, DH, generator=gen, **dev).to(bf)
        v = torch.randn(n, lk, DH, generator=gen, **dev).to(bf)
        lens = torch.randint(1, lk + 1, (b,), generator=gen, **dev)
        kv = torch.arange(lk, **dev)[None] < lens[:, None]
        add_mask = torch.where(kv, 0.0, -32752.0).to(bf).repeat_interleave(
            8, dim=0)[:, None, :]
        qkv = [q, k, v]
        leaves = [a.clone().requires_grad_() for a in qkv]
        bms, by = bound(2 * n * (2 * lq + 2 * lk) * DH + b * lk,
                        4.0 * n * lq * lk * DH)

        def sdpa(ts):
            return F.scaled_dot_product_attention(
                *ts, attn_mask=add_mask, dropout_p=RATE, scale=DH ** -0.5)

        for mode, ts in (("train", leaves), ("eval", qkv)):
            line = measure(
                lambda: masked_attention(*ts, kv, 8, DH ** -0.5, RATE, seed),
                lambda: masked_attention_plain(*qkv, kv, 8, DH ** -0.5, RATE,
                                               seed), mode)
            ctx = (torch.inference_mode if mode == "eval"
                   else contextlib.nullcontext)
            with ctx():
                lib_ms, lib_rounds = events_ms(lambda: sdpa(ts))
                lib_dev = sum(by_kernel_ms(lambda: sdpa(ts)).values())
            print(json.dumps(dict(kernel="B3 forward", call=what, cells=n,
                                  lq=lq, lk=lk, **line, bound_ms=bms,
                                  bound_by=by, sdpa_ms=lib_ms,
                                  sdpa_rounds=lib_rounds,
                                  sdpa_device_ms=lib_dev)), flush=True)
        del q, k, v, kv, add_mask, qkv, leaves
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
