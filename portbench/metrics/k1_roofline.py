"""K1's (``fused_rollout_kernel``) share of its roofline, in percent."""

from portbench.metrics._roofline import share


def read(ctx):
    return share(ctx, "fused_rollout_kernel")
