"""The least time of the calls of the program's own kernels in the traced
window (`work.py`, from shapes and valid counts) over their device time
in the trace, in %; nothing when none ran."""


def read(ctx):
    spent = ctx["trace"].kernel_s(port=True)
    if spent <= 0 or not ctx["kernel_bound_s"]:
        return None
    return 100.0 * ctx["kernel_bound_s"] / spent
