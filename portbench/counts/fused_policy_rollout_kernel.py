"""K2, ``fused_policy_rollout_kernel`` (``judo_tpu_torch/csrc/fused_policy_rollout.cu``):
every rollout's whole horizon with the locomotion policy in the loop.

Operations: rollouts x policy ticks x (the MLP, 2 (in + 1) out per layer,
plus the substeps' warm physics steps). Bytes: the policy's float32 weights
and biases once, and per rollout the initial state and last policy output,
and per tick the 25-dim command in and the state, sensors and policy output
out, at the configuration's item size."""

from portbench.counts.step import step_flops


def count(s: dict) -> tuple[float, float]:
    dims = s["mlp"]
    params = sum((dims[i] + 1) * dims[i + 1] for i in range(len(dims) - 1))
    per_tick = 2 * params + s["substeps"] * step_flops(s["nefc"], s["nv"], s["islands"], s["iterations"])
    ops = s["rollouts"] * s["steps"] * per_tick
    per_step = 25 + s["nq"] + s["nv"] + s["nsensordata"] + dims[-1]
    nbytes = 4 * params + s["itemsize"] * s["rollouts"] * (s["nq"] + s["nv"] + dims[-1] + s["steps"] * per_step)
    return float(ops), float(nbytes)
