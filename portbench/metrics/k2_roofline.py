"""K2's (``fused_policy_rollout_kernel``) share of its roofline, in percent."""

from portbench.metrics._roofline import share


def read(ctx):
    return share(ctx, "fused_policy_rollout_kernel")
