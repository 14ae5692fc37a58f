"""The host's replay of the solve graph, in ms: the mean of the controller's
``dispatch.replay`` span (the graph launch; on a mesh the copies between its
graphs) over the solves of the traced run's window (timed as in an untraced
run: the profiled slice comes after it)."""

import numpy as np

from portbench.metrics import _plan_log

before_window = _plan_log.before_window
after_window = _plan_log.after_window


def read(ctx):
    ms = _plan_log.span_ms(ctx, "dispatch.replay")
    return float(np.mean(ms)) if ms else None
