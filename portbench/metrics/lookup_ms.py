"""The solve cache's lookup before each replay, in ms: the mean of the
controller's ``prep.lookup`` span (the shape signature and the cache's
lookup, insert or evict) over the solves of the traced run's window (timed
as in an untraced run: the profiled slice comes after it)."""

import numpy as np

from portbench.metrics import _plan_log

before_window = _plan_log.before_window
after_window = _plan_log.after_window


def read(ctx):
    ms = _plan_log.span_ms(ctx, "prep.lookup")
    return float(np.mean(ms)) if ms else None
