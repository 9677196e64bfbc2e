"""Host ms a traced step in the program's own staging: its `prepare`
spans (the lr, host arrays and pinning, the key), the graph cache's
address checks (`graphs.check`) and input copies (`graphs.load`)
(`program_spans.py`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_step_ms(ctx, program_spans.STAGE)
