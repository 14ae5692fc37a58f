"""The task's host prep before each solve, in ms: the mean of the
controller's ``prep.task`` span (the task's ``pre_rollout``, whose metadata
the solve reads; fr3_pick's phase) over the solves of the traced run's
window (timed as in an untraced run: the profiled slice comes after it). A
program without the span gives None."""

import numpy as np

from portbench.metrics import _plan_log

before_window = _plan_log.before_window
after_window = _plan_log.after_window


def read(ctx):
    ms = _plan_log.span_ms(ctx, "prep.task")
    return float(np.mean(ms)) if ms else None
