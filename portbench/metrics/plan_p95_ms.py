"""The 95th percentile of the host time of every ``update_action`` call in
the traced run's window (timed as in an untraced run: the profiled slice
comes after it), in ms."""

import numpy as np


def read(ctx):
    ms = [1e3 * ctx.record.call_s[j] for j in ctx.calls]
    return float(np.percentile(ms, 95)) if ms else None
