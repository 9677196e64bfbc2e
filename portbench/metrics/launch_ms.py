"""Host ms a traced step in the program's graph replays
(`graphs.replay`, `program_spans.py`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_step_ms(ctx, program_spans.LAUNCH)
