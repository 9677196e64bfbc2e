"""Graphs captured inside the traced window (`graphs.capture` spans of
the entry calls, `program_spans.py`): a program built again, after a
cache drop or for a new shape."""

from portbench import program_spans


def read(ctx):
    spans = program_spans.anchored(ctx["trace"])
    if spans is None:
        return None
    calls = program_spans.entry_calls(spans)
    return sum(1 for s in spans
               if s.name == program_spans.CAPTURE and s.call in calls)
