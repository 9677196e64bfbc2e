#!/usr/bin/env python3
"""
Which kernels a torch.profiler trace keeps on one CUDA card as one
process ages and its traces add up, and what keeps them all:

    python3 coot_videotext_tpu_torch/tools/trace_loss.py \\
        [--rounds 12] [--gap 20]

A block of 20 products of 4096 x 4096 float32, each divided and put
through a tanh, then summed (61 kernel launches, ~55 ms on the card), is
traced in each round three ways, one after the other:
- plain: the block right after the trace opens;
- sleep: the trace idles `--sleep` seconds (default 0.25) first;
- warm: WARM_LAUNCHES small kernels are launched and waited for first.
Then the process sleeps `--gap` seconds. One JSON line a round: the
round, the process's age, the traces opened so far, and for each way the
block's kernels missing from the trace, the index (in launch order) of
the first block kernel it holds, and that kernel's start after its
launch (ms; some microseconds for the block's first kernel).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

STARTED = time.time()
WARM_LAUNCHES = 256


def traced(log_dir: Path, x, way: str, sleep_s: float) -> dict:
    """The block traced `way`; its launches and kernels by correlation."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    small = torch.zeros(8, device=x.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if way == "sleep":
            time.sleep(sleep_s)
        elif way == "warm":
            for _ in range(WARM_LAUNCHES):
                small.add_(1.0)
            torch.cuda.synchronize()
        with record_function("block"):
            y = x
            for _ in range(20):
                y = torch.tanh(y @ y / 64.0)
            y.sum().item()
        torch.cuda.synchronize()
    path = log_dir / f"{way}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    block = next(e for e in events if e.get("name") == "block"
                 and e.get("cat") == "user_annotation")
    lo, hi = block["ts"], block["ts"] + block["dur"]
    launches = sorted((e["ts"], e["args"].get("correlation"))
                      for e in events if e.get("cat") == "cuda_runtime"
                      and "LaunchKernel" in e.get("name", "")
                      and lo <= e["ts"] <= hi)
    order = {c: (i, ts) for i, (ts, c) in enumerate(launches)}
    kept = sorted((order[e["args"].get("correlation")], e["ts"])
                  for e in events if e.get("cat") == "kernel"
                  and e["args"].get("correlation") in order)
    first = kept[0] if kept else None
    return {"launches": len(launches), "missing": len(launches) - len(kept),
            "first_kept": first[0][0] if first else None,
            "first_after_launch_ms":
                (first[1] - first[0][1]) / 1e3 if first else None}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--gap", type=float, default=20.0)
    parser.add_argument("--sleep", type=float, default=0.25)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("this measures the card: no CUDA device")
    x = torch.randn(4096, 4096, device="cuda")
    opened = 0
    with tempfile.TemporaryDirectory(prefix="coot_trace_loss_") as tmp:
        for r in range(args.rounds):
            row = {"round": r, "age_s": round(time.time() - STARTED, 1),
                   "traces_before": opened}
            for way in ("plain", "sleep", "warm"):
                row[way] = traced(Path(tmp), x, way, args.sleep)
                opened += 1
            print(json.dumps(row), flush=True)
            if r + 1 < args.rounds:
                time.sleep(args.gap)
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
