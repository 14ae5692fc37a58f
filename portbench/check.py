"""What decides ``correct``: the plans the timed path published, held against
the plain reference (``reference/plan.py``) on the same inputs.

Compared are the start (the controller's first plan, from its reset: the warm
start, zero carry) and a sample of the window's plans drawn from the seed
while the window ran (``drive.CarrySample``).
The reference works each out again from what the benchmark handed the
program (the state and time, rounded to the configuration's dtype as the
program stages them) and from the seed (the program's noise: the plan's draw
from a generator seeded with it). From the program it takes, for a plan after
the start, the nominal the plan starts from (the previous plan's published
knot times and knots) and the carried rollout state (K1's warm-start forces
or K2's last policy output, copied after the previous call): it follows the
program plan by plan, and the start is worked out alone.

The numbers, each over the compared plans' finite values (a window plan
whose published outputs are not finite counts as failed, ``unsound_plans``):

- ``reward_gap_median``, ``reward_gap_p90``: |reward - reference| over
  |reference| per rollout, the median and the 90th percentile over every
  rollout of the compared plans (the spline sampling, the rollout kernel and
  the reward). Not the widest: a few rollouts in a hundred part from the
  float64 reference by up to a hundred times their reward, and the reference
  in float32 parts from it as far (PERF.md, section 2);
- ``reward_gap_index``: per rollout index, the smallest of its relative
  reward gaps over the compared plans (a gap that is not finite counts as
  infinite), the largest over the indices. A rollout whose contacts part at
  rounding parts on one plan and not on the next; a fault bound to one index
  (a warp, the last block, a single rollout) repeats on every plan, which
  the median and the 90th percentile over all rollouts would miss;
- ``knot_gap``: the published knots against the optimizer's update of the
  reference's candidates with the program's rewards (the update stage
  alone), the widest gap over the largest knot;
- ``times_gap``: the published knot times against the plan's time plus the
  knot offsets, the widest gap over the largest time;
- ``carry_gap_p90``: the carried rollout state after each compared plan (the
  step-0 forces, or the last tick's policy output) against the reference's,
  per rollout the widest gap over the rollout's largest value, the 90th
  percentile over the rollouts.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.drive import CARRY_FIELDS, Record
from portbench.reference import plan as ref_plan

NUMBERS = ("reward_gap_median", "reward_gap_p90", "reward_gap_index", "knot_gap", "times_gap", "carry_gap_p90")

# The control: the reference in the precision below the configuration's, in the program's place.
CONTROL_DTYPE = {"float64": "float32", "float32": "bfloat16"}


def noise(seed: int, plans: list[int], shape: tuple, dtype, device) -> dict:
    """Each plan's standard normal noise: call j's is the (j + 1)-th draw of
    ``shape`` from a generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    want, out = set(plans), {}
    for j in range(max(plans) + 1):
        n = torch.randn(shape, generator=g, dtype=dtype, device=device)
        if j in want:
            out[j] = n.double().cpu().numpy()
    return out


def inputs(setup: ref_plan.Setup, rec: Record, plans: list[int], draws: dict, R: int, np_dtype) -> list:
    """The reference's inputs of each plan, rounded to the program's dtype."""
    rnd = lambda x: np.asarray(x, np.float64).astype(np_dtype).astype(np.float64)  # noqa: E731
    k = CARRY_FIELDS.index("last_policy_output" if setup.policy is not None else "efc_warm")
    start_times, start_knots, start_carry = setup.start(R)
    out = []
    for j in plans:
        if j == 0:
            prev_times, prev_knots, carry = start_times, start_knots, start_carry
        else:
            prev_times, prev_knots, _ = rec.published[j - 1]
            carry = rec.carry[j][0][k].double().cpu().numpy()
        out.append(ref_plan.PlanInput(rnd(rec.states[j]), float(rnd(rec.times[j])), rnd(prev_times), rnd(prev_knots),
                                      rnd(carry), draws[j]))
    return out


def program_outputs(setup: ref_plan.Setup, rec: Record, plans: list[int]) -> dict:
    """What the program published for each plan, and its carry after it, as float64."""
    k = CARRY_FIELDS.index("last_policy_output" if setup.policy is not None else "efc_warm")
    return {
        "times": np.stack([rec.published[j][0] for j in plans]),
        "knots": np.stack([rec.published[j][1] for j in plans]),
        "rewards": np.stack([rec.published[j][2] for j in plans]),
        "carry": np.stack([rec.carry[j][1][k].double().cpu().numpy() for j in plans]),
    }


def control_outputs(setup: ref_plan.Setup, plan_inputs: list, dtype, device) -> dict:
    """The reference in the program's place, computed in ``dtype``."""
    out = ref_plan.plan(setup, plan_inputs, dtype, device)
    f64 = lambda x: x.double().cpu().numpy()  # noqa: E731
    return {"times": f64(out.times), "knots": f64(out.knots), "rewards": f64(out.rewards), "carry": f64(out.carry)}


def _widest(a: np.ndarray, b: np.ndarray) -> float:
    """The widest finite gap of ``a`` from ``b`` over the largest finite |b|."""
    ok = np.isfinite(a) & np.isfinite(b)
    if not ok.any():
        return float("nan")
    return float(np.max(np.abs(a - b)[ok]) / max(float(np.max(np.abs(b[ok]))), 1e-300))


def _per_rollout(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P, R, C) -> (P * R,): each rollout's widest gap over its largest |b|
    (at least a millionth of the largest of all), finite rows only."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    ok = np.isfinite(a).all(-1) & np.isfinite(b).all(-1)
    if not ok.any():
        return np.array([np.nan])
    a, b = a[ok], b[ok]
    scale = np.maximum(np.abs(b).max(-1), 1e-6 * np.abs(b).max())
    return np.abs(a - b).max(-1) / np.maximum(scale, 1e-300)


def numbers(setup: ref_plan.Setup, ref: ref_plan.PlanOutput, got: dict) -> dict:
    """The compared numbers of ``got`` (a producer's outputs) against the reference."""
    r_ref = ref.rewards.double().cpu().numpy()
    ok = np.isfinite(got["rewards"]) & np.isfinite(r_ref)
    gaps = np.where(ok, np.abs(got["rewards"] - r_ref) / np.maximum(np.abs(r_ref), 1e-300), np.inf)  # (P, R)
    rel = gaps[ok]
    stage = ref_plan.update(setup, ref.candidates, torch.as_tensor(got["rewards"], dtype=ref.candidates.dtype,
                                                                    device=ref.candidates.device))
    nan = float("nan")
    return {
        "reward_gap_median": float(np.median(rel)) if rel.size else nan,
        "reward_gap_p90": float(np.quantile(rel, 0.9)) if rel.size else nan,
        "reward_gap_index": float(np.max(np.min(gaps, axis=0))) if rel.size else nan,
        "knot_gap": _widest(got["knots"], stage.double().cpu().numpy()),
        "times_gap": _widest(got["times"], ref.times.double().cpu().numpy()),
        "carry_gap_p90": float(np.quantile(_per_rollout(got["carry"], ref.carry.double().cpu().numpy()), 0.9)),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    out, ok = {}, True
    for name in NUMBERS:
        v, lim = values[name], limits.get(name)
        finite = bool(np.isfinite(v))
        ok = ok and finite and lim is not None and v <= lim
        out[name] = {"value": v if finite else None, "limit": lim}
    return ok, out


def unsound_plans(rec: Record, plans: range, bounds: np.ndarray) -> int:
    """The plans (the window's) whose published rewards or knots are not
    finite, or whose knots leave the control bounds (rounding aside)."""
    bad = 0
    for times, knots, rewards in (rec.published[j] for j in plans):
        finite = np.all(np.isfinite(knots)) and np.all(np.isfinite(rewards)) and np.all(np.isfinite(times))
        inside = np.all(knots >= bounds[:, 0] - 1e-6) and np.all(knots <= bounds[:, 1] + 1e-6)
        bad += not (finite and inside)
    return bad


def run(setup: ref_plan.Setup, rec: Record, seed: int, R: int, device, producer: str = "program") -> dict:
    """The compared numbers of a run, over the plans whose carry ``rec``
    kept: the program's (``producer`` "program"); the control's ("control":
    the reference in ``CONTROL_DTYPE`` of the configuration's dtype in the
    program's place); or the witness's ("witness": the reference in the
    configuration's own dtype in the program's place)."""
    dtype = setup.config["dtype"]
    np_dtype = np.dtype(dtype)
    plans = sorted(rec.carry)
    shape = (R - 1, setup.config["optimizer_config"]["num_nodes"], setup.nu)
    draws = noise(seed, plans, shape, getattr(torch, dtype), device)
    plan_inputs = inputs(setup, rec, plans, draws, R, np_dtype)
    ref = ref_plan.plan(setup, plan_inputs, torch.float64, device)
    if producer == "program":
        got = program_outputs(setup, rec, plans)
    else:
        ref_dtype = {"control": CONTROL_DTYPE[dtype], "witness": dtype}[producer]
        got = control_outputs(setup, plan_inputs, getattr(torch, ref_dtype), device)
    return numbers(setup, ref, got)
