"""Device ms a traced train step from its backward phase mark to its
optimizer mark: the backward, and the gradients' reduction under a mesh
(`program_spans.py`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.phase_ms(ctx, "backward")
