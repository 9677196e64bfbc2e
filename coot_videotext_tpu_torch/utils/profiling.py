"""
Profiling utilities: device memory and host RAM samples, `torch.profiler`
traces, the program's host spans, seeding and parameter counts.

Port of coot_videotext_tpu/utils/profiling.py (`profile_device_and_ram`
:22, `trace` :51, `set_seed` :69, `count_parameters` :84; reference
nntrainer/utils_torch.py:54-228). The device's memory comes from
`torch.cuda.memory_stats` (bytes allocated by tensors, JAX's
`bytes_in_use`) and `torch.cuda.mem_get_info` (the card's total, in place
of the allocator limit JAX reads), host RAM from psutil where it imports,
else from /proc/meminfo. `trace` writes a Chrome trace of the block
(CPU and, on the card, CUDA activity) that Perfetto or
chrome://tracing opens, with the program's spans on a track of their own.

Spans (`span`) record the host side of the program's entries while a
torch profiler records, and nothing otherwise: the four entries (the
retrieval group and eval steps, the caption train step and
`Translator.translate_batch`) open one each per call, and their host
work, the graph cache's check, loads, captures, replays and eager runs
(utils/graphs.py) and the decodes' reads open spans inside it. A span is
stamped with `time.time_ns()`, the clock of the profiler's absolute event
times, so it sits on a trace's timeline; it is not a profiler range,
whose device-side projection a trace's reader would count as device work.
The trainers' meters do not call this module, as JAX's do not. The train
steps' device-side phase marks are kernels (ops/phase.py).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.autograd import profiler as _torch_profiler

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
# the spans a session keeps; later ones are counted as dropped
SPAN_CAPACITY = 100_000
SPAN_TRACK = "program spans"  # their track in `trace`'s Chrome trace


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
    file is the `trace_file` attribute after the block. The program's
    spans of the block are written into it as complete events of a
    process of their own (SPAN_TRACK), nested as they ran."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    _SPANS.live = False  # the block's spans are a session of their own
    with torch.profiler.profile(activities=activities) as prof:
        if torch.cuda.is_available():
            warm_trace()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_file = log_dir / f"trace_{get_timestamp_for_filename()}.json"
    prof.export_chrome_trace(str(prof.trace_file))
    _add_span_track(prof.trace_file, last_session().spans)


def warm_trace() -> None:
    """TRACE_WARMUP_LAUNCHES empty kernels on the current CUDA device, waited
    for: the first thing in an open trace (`trace` calls it). A count of the
    traced work leaves out their TRACE_WARMUP_LAUNCHES launches, the kernels
    named WARMUP_KERNEL and the device-side span of WARMUP_RANGE."""
    with torch.profiler.record_function(WARMUP_RANGE):
        for _ in range(TRACE_WARMUP_LAUNCHES):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()


class Span(NamedTuple):
    """A span: `call` is shared by every span of one entry call, `parent`
    is the index of the enclosing span in the session's spans (-1 at an
    entry); times are `time.time_ns()` stamps, `end_ns` 0 while open."""
    name: str
    call: int
    parent: int
    start_ns: int
    end_ns: int


class Session(NamedTuple):
    """The spans of a profiler session, in the order they opened, and the
    count of spans past SPAN_CAPACITY that were not kept."""
    spans: List[Span]
    dropped: int


class _Spans:
    """The buffer of the current or last session. `live` is False once a
    span has found the profiler off (or `trace` opens a block): the next
    span that records starts a new session."""
    __slots__ = ("records", "dropped", "stack", "calls", "session", "live")

    def __init__(self) -> None:
        self.records: list = []  # [name, call, parent, start, end]
        self.dropped = 0
        self.stack: list = []  # the open recorded spans (index, call)
        self.calls = 0
        self.session = 0
        self.live = False

    def begin(self) -> None:
        self.records, self.stack = [], []
        self.dropped = self.calls = 0
        self.session += 1
        self.live = True


_SPANS = _Spans()


class _Off:
    """The context of a span while no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()


class _Recording:
    """The context of a span while a profiler records."""
    __slots__ = ("name", "index", "session")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        rec = _SPANS
        if not rec.live:
            rec.begin()
        if rec.stack:
            parent, call = rec.stack[-1]
        else:
            rec.calls += 1
            parent, call = -1, rec.calls
        if len(rec.records) < SPAN_CAPACITY:
            self.index = len(rec.records)
            rec.records.append([self.name, call, parent, time.time_ns(), 0])
        else:
            self.index = -1
            rec.dropped += 1
        self.session = rec.session
        rec.stack.append((self.index, call))

    def __exit__(self, exc_type, exc, tb) -> None:
        rec = _SPANS
        if self.session != rec.session:  # a new session began inside it
            return
        rec.stack.pop()
        if self.index >= 0:
            rec.records[self.index][4] = time.time_ns()


def span(name: str):
    """A host span of the program, `with span("graphs.replay"): ...`:
    recorded while a torch profiler records (the flag
    `torch.autograd.profiler._is_profiler_enabled`), else one check of
    that flag. The first span that records after one found the profiler
    off begins a new session, which clears the last one."""
    if not _torch_profiler._is_profiler_enabled:
        _SPANS.live = False
        return _OFF
    return _Recording(name)


def last_session() -> Session:
    """The spans of the current or last profiler session."""
    return Session([Span(*r) for r in _SPANS.records], _SPANS.dropped)


def _add_span_track(path: Path, spans: List[Span]) -> None:
    """Writes `spans` into the Chrome trace at `path`, on its timeline
    (its `baseTimeNanoseconds`), as complete events of the process
    SPAN_TRACK on one row, each with its call id and parent."""
    if not spans:
        return
    with open(path, encoding="utf8") as fh:
        data = json.load(fh)
    base = int(data.get("baseTimeNanoseconds", 0))
    events = data.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_TRACK,
                   "tid": 0, "args": {"name": SPAN_TRACK}})
    for s in spans:
        if not s.end_ns:
            continue
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": SPAN_TRACK, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"call": s.call, "parent": s.parent}})
    with open(path, "w", encoding="utf8") as fh:
        json.dump(data, fh)


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
