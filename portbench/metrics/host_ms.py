"""Host ms a call of the window: the benchmark's spans from the call into
the cell's entry (a train step or group, an eval request, a
`translate_batch`) until it returns, summed over the window, over its
calls (a train group counts its steps)."""


def read(ctx):
    if not ctx["host_calls"]:
        return None
    return 1e3 * ctx["host_s"] / ctx["host_calls"]
