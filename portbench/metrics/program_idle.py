"""The share of the traced window, in %, in which no kernel runs while
the host is inside one of the program's entry spans (anchored,
`program_spans.py`): the idle the program's own host work causes. The
rest of `device_idle` is the caller's (its reads, its loop)."""

from portbench import program_spans


def read(ctx):
    tr = ctx["trace"]
    spans = program_spans.anchored(tr)
    if spans is None or tr.window_s <= 0:
        return None
    idle = program_spans.idle_intervals(tr)
    return 100.0 * program_spans.inside_entries_s(spans, idle) \
        / tr.window_s
