"""K1, ``fused_rollout_kernel`` (``judo_tpu_torch/csrc/fused_rollout.cu``):
every rollout's whole horizon, warm-started from the previous solve's forces.

Operations: rollouts x steps x substeps x one warm step. Bytes: each input
read once and each output written once (the initial state, the warm-start
forces in and the step-0 forces out, and per step the controls in and the
state and sensors out), at the configuration's item size."""

from portbench.counts.step import step_flops


def count(s: dict) -> tuple[float, float]:
    ops = s["rollouts"] * s["steps"] * s["substeps"] * step_flops(s["nefc"], s["nv"], s["islands"], s["iterations"])
    per_step = s["nu"] + s["nq"] + s["nv"] + s["nsensordata"]
    nbytes = s["itemsize"] * s["rollouts"] * (s["nq"] + s["nv"] + 2 * s["nefc"] + s["steps"] * per_step)
    return float(ops), float(nbytes)
