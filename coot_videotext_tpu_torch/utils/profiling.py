"""
Profiling utilities: device memory and host RAM samples, `torch.profiler`
traces, seeding and parameter counts.

Port of coot_videotext_tpu/utils/profiling.py (`profile_device_and_ram`
:22, `trace` :51, `set_seed` :69, `count_parameters` :84; reference
nntrainer/utils_torch.py:54-228). The device's memory comes from
`torch.cuda.memory_stats` (bytes allocated by tensors, JAX's
`bytes_in_use`) and `torch.cuda.mem_get_info` (the card's total, in place
of the allocator limit JAX reads), host RAM from psutil where it imports,
else from /proc/meminfo. `trace` writes a Chrome trace of the block
(CPU and, on the card, CUDA activity) that Perfetto or
chrome://tracing opens. The trainers' meters do not call this module,
as JAX's do not.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn

from coot_videotext_tpu_torch.utils.general import (
    get_timestamp_for_filename)

GB = 1024 ** 3
# On the card a torch.profiler trace loses the first kernels it should hold,
# the more the older the process (on an H100 host 18 of a block's 61 four
# minutes in, ~60 fourteen minutes in; idling first does not help:
# tools/trace_loss.py, chip_smoke.py). `warm_trace` launches this many
# empty kernels (WARMUP_KERNEL, `torch.cuda._sleep(0)`) first, to be lost
# in their place, under the range WARMUP_RANGE.
TRACE_WARMUP_LAUNCHES = 512
WARMUP_KERNEL = "spin_kernel"
WARMUP_RANGE = "trace warm-up"


def _host_ram() -> Tuple[float, float]:
    """(total, available) bytes of host RAM."""
    try:
        import psutil
    except ImportError:
        info = {}
        for line in Path("/proc/meminfo").read_text().splitlines():
            name, value = line.split(":", 1)
            info[name] = float(value.split()[0]) * 1024  # kB
        return info["MemTotal"], info["MemAvailable"]
    vm = psutil.virtual_memory()
    return float(vm.total), float(vm.available)


def profile_device_and_ram(device: Optional[torch.device] = None
                           ) -> Dict[str, float]:
    """Device and host memory (GB, fractions): device_mem_used,
    device_mem_limit, device_mem_percent, ram_used, ram_total,
    ram_percent. `device` defaults to the current CUDA device where there
    is one; a CPU device's stats are 0, as on JAX's CPU backend."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    out = {"device_mem_used": 0.0, "device_mem_limit": 0.0,
           "device_mem_percent": 0.0}
    if device is not None and torch.device(device).type == "cuda":
        used = torch.cuda.memory_stats(device).get(
            "allocated_bytes.all.current", 0)
        limit = torch.cuda.mem_get_info(device)[1]
        out["device_mem_used"] = used / GB
        out["device_mem_limit"] = limit / GB
        out["device_mem_percent"] = used / limit
    total, available = _host_ram()
    out["ram_used"] = (total - available) / GB
    out["ram_total"] = total / GB
    out["ram_percent"] = (total - available) / total
    return out


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]) -> Iterator[torch.profiler.profile]:
    """A `torch.profiler` trace of the enclosed block, written to
    `<log_dir>/trace_<timestamp>.json`:

        with profiling.trace("experiments/.../profiles") as prof:
            train_step(...)

    The profiler is yielded (`key_averages()` for sums by kernel); its
    file is the `trace_file` attribute after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        if torch.cuda.is_available():
            warm_trace()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_file = log_dir / f"trace_{get_timestamp_for_filename()}.json"
    prof.export_chrome_trace(str(prof.trace_file))


def warm_trace() -> None:
    """TRACE_WARMUP_LAUNCHES empty kernels on the current CUDA device, waited
    for: the first thing in an open trace (`trace` calls it). A count of the
    traced work leaves out their TRACE_WARMUP_LAUNCHES launches, the kernels
    named WARMUP_KERNEL and the device-side span of WARMUP_RANGE."""
    with torch.profiler.record_function(WARMUP_RANGE):
        for _ in range(TRACE_WARMUP_LAUNCHES):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()


def set_seed(seed: int) -> None:
    """Seed python's random, numpy's global generator and torch's CPU and
    CUDA generators (reference utils_torch.py:54; the port's train steps
    draw from their own seed states, ops/philox.py)."""
    import random

    import numpy as np
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def count_parameters(module: nn.Module) -> Tuple[int, int]:
    """(total, trainable) parameter counts of a module."""
    total = sum(p.numel() for p in module.parameters())
    trainable = sum(p.numel() for p in module.parameters()
                    if p.requires_grad)
    return total, trainable
