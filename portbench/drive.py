"""Driving the port: one controller built from a configuration, fed a seeded
stream of states, warmed up, then called back to back for the timed window.

The window calls ``Controller.update_action()`` with nothing between two
calls but the benchmark's own bookkeeping: it sets ``current_state`` and
``time`` from the stream before each call, and after it keeps the host time
of the call, the controller's ``last_plan_timing`` and, on the card, copies
of the carried rollout state for the sampled plans (``CarrySample``). What
each plan publishes (knot times, knots, rewards) is taken where the
controller publishes it, through its ``update_spline``. The garbage
collector runs as it would for a user.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# The carried solver state's fields that a plan's rollouts read and write:
# the warm-start forces (K1) and the last policy output (K2).
CARRY_FIELDS = ("efc_warm", "last_policy_output")


class StateStream:
    """The state of plan ``j``: the configuration's base state plus the
    workload's seeded perturbations, drawn plan after plan from ``seed``."""

    def __init__(self, config: dict, workload: dict, seed: int) -> None:
        qpos = np.asarray(config["state"]["qpos"], np.float64)
        qvel = np.asarray(config["state"].get("qvel", np.zeros(config["state"]["nv"])), np.float64)
        self.nq = qpos.shape[0]
        self.base = np.concatenate([qpos, qvel])
        self.perturb = workload["perturb"]
        self.rng = np.random.default_rng(seed)
        self.states: list[np.ndarray] = []

    def __call__(self, j: int) -> np.ndarray:
        while len(self.states) <= j:
            s = self.base.copy()
            for p in self.perturb:
                lo = p["start"] + (0 if p["part"] == "qpos" else self.nq)
                hi = p["stop"] + (0 if p["part"] == "qpos" else self.nq)
                s[lo:hi] += p["scale"] * self.rng.standard_normal(hi - lo)
            self.states.append(s)
        return self.states[j]


def build(config: dict, workload: dict, seed: int, device):
    """A controller of the port as the configuration states it."""
    from judo_tpu_torch.controller import make_controller

    c = make_controller(config["task"], config["optimizer"], device=device, dtype=getattr(torch, config["dtype"]),
                        seed=seed)
    for target, values in ((c.controller_cfg, config["controller"]), (c.optimizer_cfg, config["optimizer_config"]),
                           (c.task.config, config["task_config"])):
        for k, v in values.items():
            if not hasattr(target, k):
                raise AttributeError(f"{type(target).__name__} has no field {k!r}")
            setattr(target, k, np.asarray(v, np.float64) if isinstance(v, list) else v)
    c.optimizer_cfg.num_rollouts = workload["rollouts"]
    c.controller_cfg.pipeline_depth = workload["pipeline_depth"]
    return c


@dataclass
class Record:
    """What the benchmark keeps of every call, warm-up included, by index."""

    states: list = field(default_factory=list)  # the state handed to call j
    times: list = field(default_factory=list)  # the time handed to call j
    call_s: list = field(default_factory=list)  # host seconds of call j
    timing: list = field(default_factory=list)  # last_plan_timing after call j
    published: list = field(default_factory=list)  # (knot times, knots, rewards) of solve j, as published
    # the carried rollout state before and after call j, on the card, for the
    # start (call 0; before it: None, the reset's zeros) and the sampled plans
    carry: dict = field(default_factory=dict)


def watch(c, rec: Record) -> None:
    """Keep each plan's published knot times, knots and rewards: the
    controller publishes a solve's mirror by setting ``rewards`` and then
    calling ``update_spline(times, knots)``, in solve order."""
    publish = c.update_spline

    def update_spline(times, knots):
        rec.published.append((np.asarray(times), np.asarray(knots), np.asarray(c.rewards)))
        publish(times, knots)

    c.update_spline = update_spline


def carry_of(c) -> tuple:
    """The carried rollout state after the last call (the controller's own tensors)."""
    return tuple(getattr(c._carry, f) for f in CARRY_FIELDS)


def _copy(dst: tuple, src: tuple) -> None:
    for d, s_ in zip(dst, src):
        if d is not None:
            d.copy_(s_)


class CarrySample:
    """Copies, on the card, of the carried rollout state before and after
    ``k`` of the window's plans, drawn by reservoir sampling from ``rng``:
    after n window plans each of them is kept with probability k / n. The
    copies go into buffers made before the window and are queued behind each
    call on the current stream, so nothing is allocated on the card inside
    the window and nothing waits for it."""

    def __init__(self, c, k: int, rng: np.random.Generator) -> None:
        make = lambda: tuple(None if t is None else torch.empty_like(t) for t in carry_of(c))  # noqa: E731
        self.prev = make()  # the carry after the last call
        self.slots = [(make(), make()) for _ in range(k)]
        self.plans: list = [None] * k
        self.seen, self.rng = 0, rng

    def keep(self, c, j: int) -> None:
        """After window call ``j``."""
        cur = carry_of(c)
        self.seen += 1
        slot = self.seen - 1 if self.seen <= len(self.slots) else int(self.rng.integers(self.seen))
        if slot < len(self.slots):
            _copy(self.slots[slot][0], self.prev)
            _copy(self.slots[slot][1], cur)
            self.plans[slot] = j
        _copy(self.prev, cur)

    def follow(self, c) -> None:
        """After a call outside the window."""
        _copy(self.prev, carry_of(c))

    def into(self, rec: Record) -> None:
        for j, (before, after) in zip(self.plans, self.slots):
            if j is not None:
                rec.carry[j] = (before, after)


def call(c, rec: Record, stream: StateStream, period: float, span=None, sample: CarrySample | None = None,
         window: bool = False) -> float:
    """One plan: set the state and time, call ``update_action``, keep the
    record. ``span(name)`` opens a trace span around each part."""
    span = span or (lambda name: contextlib.nullcontext())
    j = len(rec.call_s)
    with span("portbench.stage"):
        state, t = stream(j), j * period
        c.current_state = state
        c.time = t
    t0 = time.perf_counter()
    with span("portbench.call"):
        c.update_action()
    t1 = time.perf_counter()
    with span("portbench.record"):
        rec.states.append(state)
        rec.times.append(t)
        rec.call_s.append(t1 - t0)
        rec.timing.append(c.last_plan_timing)
        if j == 0:
            rec.carry[0] = (None, tuple(None if x is None else x.clone() for x in carry_of(c)))
        if sample is not None:
            sample.keep(c, j) if window else sample.follow(c)
    return t1


def flush(c) -> None:
    """Publish every plan in flight and wait for the card."""
    c.flush_pipeline()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
