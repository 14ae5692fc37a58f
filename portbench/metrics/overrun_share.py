"""The share of the traced run's window's solves whose ``plan`` span
outlasted the controller's control period (1000 / ``control_freq`` ms), in
percent, from the controller's ``plan_log`` records. A program without the
records gives None."""

from portbench.metrics import _plan_log


def before_window(ctx) -> None:
    _plan_log.before_window(ctx)
    ctx.store["period_ms"] = 1e3 / ctx.program.controller_cfg.control_freq


after_window = _plan_log.after_window


def read(ctx):
    ms = _plan_log.span_ms(ctx, "plan")
    return 100.0 * sum(m > ctx.store["period_ms"] for m in ms) / len(ms) if ms else None
