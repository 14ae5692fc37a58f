"""The host controller's prep per plan, in ms: the mean of the controller's
``last_plan_timing["prep_ms"]`` (host staging, the solve cache's lookup) over
every call of the traced run's window (timed as in an untraced run: the
profiled slice comes after it)."""

import numpy as np


def read(ctx):
    prep = [ctx.record.timing[j]["prep_ms"] for j in ctx.calls if ctx.record.timing[j]]
    return float(np.mean(prep)) if prep else None
