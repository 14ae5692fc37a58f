"""The publish of a solve's mirror once it is on the host, in ms: the mean
of the controller's ``publish`` span (the mirror's unpack and the new
spline, under the mirror lock) over the solves of the traced run's window
(timed as in an untraced run: the profiled slice comes after it)."""

import numpy as np

from portbench.metrics import _plan_log

before_window = _plan_log.before_window
after_window = _plan_log.after_window


def read(ctx):
    ms = _plan_log.span_ms(ctx, "publish")
    return float(np.mean(ms)) if ms else None
