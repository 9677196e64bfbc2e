"""
The program's own host spans and device phase marks in a traced window.

The program records its host spans while a profiler records
(`coot_videotext_tpu_torch.utils.profiling.last_session`): one entry span
a call into it (`ENTRIES`), holding `prepare`, the graph layer's
`graphs.check`, `.load`, `.capture`, `.replay` and `.run`, and the
decodes' `read`. They are stamped on the profiler's absolute clock, while
a `Trace` keeps times relative to the trace's start, so `anchored` places
the session on the trace's timeline: the i-th benchmark span around a
call into the program pairs with the i-th entry span, the offset is the
median of the pairs' start differences, and there is no reading when the
counts or the names differ, when the program dropped spans, or when a
shifted entry span lies outside its benchmark span by more than
SLACK_S.

Its train steps launch an empty kernel at each phase boundary
(`phase_mark_forward`, `_backward`, `_optimizer`, `_end`); `phase_steps`
finds them among the trace's kernels by name and keeps the steps whose
four marks all fall in the window, in order.

A program without spans or marks (an older one) gives no reading, and
nothing here raises for it.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

# the benchmark's span around each call into the program, and that
# call's entry span in the program
ENTRIES = {"train_group": "retrieval.train_group",
           "eval_request": "retrieval.eval_step",
           "decode_batch": "caption.translate_batch",
           "train_step": "caption.train_step"}
SLACK_S = 50e-6
PHASES = ("forward", "backward", "optimizer", "end")
MARK = re.compile(r"phase_mark_(\w+)")
STAGE = ("prepare", "graphs.check", "graphs.load")
LAUNCH = ("graphs.replay",)
CAPTURE = "graphs.capture"


class Span(NamedTuple):
    """A program span on the trace's timeline (seconds); `parent` indexes
    the session's spans (-1 at an entry)."""
    name: str
    call: int
    parent: int
    start: float
    end: float


def session():
    """The program's last span session, or None where it records none."""
    try:
        from coot_videotext_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_session", None)
    return None if last is None else last()


def anchored(trace, sess=None) -> Optional[List[Span]]:
    """The session's spans shifted onto `trace`'s timeline (see the
    module docstring), or None."""
    sess = session() if sess is None else sess
    if sess is None or sess.dropped:
        return None
    calls = sorted((s for s in trace.spans if s[0] in ENTRIES),
                   key=lambda s: s[1])
    entries = [s for s in sess.spans if s.parent < 0
               and s.name in ENTRIES.values()]
    if not calls or len(calls) != len(entries):
        return None
    if any(ENTRIES[c[0]] != e.name or not e.end_ns
           for c, e in zip(calls, entries)):
        return None
    diffs = sorted(round(c[1] * 1e9) - e.start_ns
                   for c, e in zip(calls, entries))
    offset = diffs[(len(diffs) - 1) // 2]  # the low median, in ns
    spans = [Span(s.name, s.call, s.parent, (s.start_ns + offset) / 1e9,
                  (s.end_ns + offset) / 1e9 if s.end_ns else 0.0)
             for s in sess.spans]
    for (_, b0, b1), e in zip(calls, entries):
        start, end = (e.start_ns + offset) / 1e9, (e.end_ns + offset) / 1e9
        if start < b0 - SLACK_S or end > b1 + SLACK_S:
            return None
    return spans


def entry_calls(spans: Sequence[Span]) -> set:
    return {s.call for s in spans if s.parent < 0
            and s.name in ENTRIES.values()}


def span_s(spans: Sequence[Span], names: Tuple[str, ...]) -> float:
    """Seconds in spans named `names` of the entry calls, a span inside
    another of them counted once."""
    calls = entry_calls(spans)
    total = 0.0
    for s in spans:
        if s.name not in names or s.call not in calls or not s.end:
            continue
        p = s.parent
        while p >= 0 and spans[p].name not in names:
            p = spans[p].parent
        if p < 0:
            total += s.end - s.start
    return total


def per_step_ms(ctx, names: Tuple[str, ...]) -> Optional[float]:
    """Host ms a step of the window in spans named `names`, or None."""
    spans = anchored(ctx["trace"])
    if spans is None or not ctx["steps"]:
        return None
    return 1e3 * span_s(spans, names) / ctx["steps"]


def phase_steps(trace) -> List[Dict[str, float]]:
    """{phase: its mark's start} of every step whose four marks lie in
    the window, in order."""
    marks = []
    for name, start, _ in trace.kernels:
        m = MARK.search(name)
        if m and m.group(1) in PHASES:
            marks.append((start, m.group(1)))
    steps, current = [], {}
    for start, phase in sorted(marks):
        if phase == PHASES[len(current)]:
            current[phase] = start
        else:
            current = {"forward": start} if phase == "forward" else {}
        if len(current) == len(PHASES):
            steps.append(current)
            current = {}
    return steps


def phase_ms(ctx, phase: str) -> Optional[float]:
    """Device ms a kept step from the mark of `phase` to the next mark."""
    steps = phase_steps(ctx["trace"])
    if not steps:
        return None
    following = PHASES[PHASES.index(phase) + 1]
    return 1e3 * sum(s[following] - s[phase] for s in steps) / len(steps)


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The parts of the window that no kernel covers."""
    out, cursor = [], trace.t0
    for s, e in trace.busy_intervals() + [(trace.t1, trace.t1)]:
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    return out


def inside_entries_s(spans: Sequence[Span],
                     intervals: Sequence[Tuple[float, float]]) -> float:
    """Seconds of `intervals` during which the host is inside an entry
    span."""
    entries = sorted((s.start, s.end) for s in spans if s.parent < 0
                     and s.name in ENTRIES.values())
    total = 0.0
    for a, b in intervals:
        for s, e in entries:
            total += max(0.0, min(b, e) - max(a, s))
    return total
