"""The traced window's valid work (`work.py`, from shapes and valid
counts: forward and backward products in training, the forward in
serving, each decoded position's forward once, as a decoder with a cache
runs it) over the window's seconds times the peak of the compute dtype,
in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0 or not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / (tr.window_s * ctx["peak_flops"])
