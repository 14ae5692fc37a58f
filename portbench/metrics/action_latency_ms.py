"""A plan's action latency, in ms: the median over the solves of the traced
run's window of the controller's ``latency_ms``, from the entry of the
``update_action`` call that took the solve's state to the end of that
solve's ``publish`` span, when ``action(t)`` starts to read the new plan. At
pipeline depth d a solve is published several calls after the one that
dispatched it."""

import numpy as np

from portbench.metrics import _plan_log

before_window = _plan_log.before_window
after_window = _plan_log.after_window


def read(ctx):
    ms = _plan_log.latency_ms(ctx)
    return float(np.median(ms)) if ms else None
