"""A kernel's share of its roofline: the least time the card could take for
one launch (``counts/<kernel>.py`` against ``counts/peaks.py``) over the
launch's mean device time in the traced slice, in percent."""

from portbench import cells
from portbench.counts import peaks


def share(ctx, kernel: str):
    events = ctx.slice.kernels(kernel)
    if not events:
        return None
    mean_s = sum(e["dur"] for e in events) / len(events) / 1e6
    bound, _ = peaks.bound_s(*cells.kernel_count(kernel).count(ctx.shapes))
    return 100.0 * bound / mean_s
