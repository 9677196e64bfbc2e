"""Device ms a traced train step from its optimizer phase mark to its end
mark: the clip, RAdam or BertAdam, the EMA (`program_spans.py`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.phase_ms(ctx, "optimizer")
