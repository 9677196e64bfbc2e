"""1 - the union of the kernels' intervals over the traced window, in
%."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
