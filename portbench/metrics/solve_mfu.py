"""The whole plan's share of the card's float32 peak, in percent: the plan's
operations (its rollout kernel's count, ``counts/<rollout_kernel>.py``, at
one launch a plan) over the card's time per plan times the peak. The card's
time per plan is the traced slice's length, from the first launch of the
rollout kernel to the end of the last, over its launches: it holds every
launch whole, so the share stays under the kernel's roofline."""

from portbench import cells
from portbench.counts import peaks


def read(ctx):
    if ctx.slice.plans == 0:
        return None
    flops, _ = cells.kernel_count(ctx.config["rollout_kernel"]).count(ctx.shapes)
    plan_s = ctx.slice.window_s / ctx.slice.plans
    return 100.0 * flops / (plan_s * peaks.PEAK_F32_FLOPS)
