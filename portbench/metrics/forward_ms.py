"""Device ms a traced train step from its forward phase mark to its
backward mark: sampling, the forward and the loss (`program_spans.py`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.phase_ms(ctx, "forward")
