"""Device ms a traced train step inside the TransformerXL's relative
attention: from each `phase_mark_relattn` to the next
`phase_mark_relattn_end`, in the forward and again in the backward
(ops/phase.py `Bracket`), summed over the steps whose four phase marks
lie in the window (`program_spans.py`); nothing where no step holds
them."""

import re

from portbench import program_spans

OPEN, CLOSE = "relattn", "relattn_end"
MARK = re.compile(r"phase_mark_(relattn(?:_end)?)\b")


def read(ctx):
    tr = ctx["trace"]
    steps = program_spans.phase_steps(tr)
    marks = sorted((start, m.group(1)) for name, start, _ in tr.kernels
                   for m in [MARK.search(name)] if m)
    total, pairs, opened = 0.0, 0, None
    for start, name in marks:
        if not any(s["forward"] <= start <= s["end"] for s in steps):
            continue
        if name == OPEN:
            opened = start
        elif opened is not None:
            total += start - opened
            pairs += 1
            opened = None
    if not steps or not pairs:
        return None
    return 1e3 * total / len(steps)
