"""One planning solve, the plain way, for a batch of plans at once: the
benchmark's reference for what the port's ``Controller.update_action``
publishes (counterpart of ``judo_tpu_torch/controller/controller.py:solve``
with one optimizer iteration and no action normalizer).

A plan reads the state and time it was given, the nominal spline it starts
from (knot times and knots), the carried rollout state (K1's warm-start
forces, or K2's last policy output) and its standard normal noise. It
resamples the nominal at the new knot times, samples the candidates, clips
them to the control bounds, evaluates the candidate splines at the rollout
times, rolls them out, scores them and updates the nominal. The rollouts of
every plan of the batch run as one batch.

This module and those it imports read nothing of the port: the model and the
policy weights come from their files, the task's pieces from
``reference/tasks/<task>.py``, the optimizer's from
``reference/optimizers/<optimizer>.py``.
"""

from __future__ import annotations

import importlib
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.model import PhysicsModel, load_snapshot, num_constraint_rows
from portbench.reference.policy import Policy, load_policy
from portbench.reference.rollout import policy_rollout, rollout
from portbench.reference.splines import eval_spline


class PlanInput(NamedTuple):
    state: np.ndarray  # (nq + nv,)
    time: float
    prev_times: np.ndarray  # (N,) knot times of the nominal the plan starts from
    prev_knots: np.ndarray  # (N, nu)
    carry: np.ndarray  # (R, nefc) warm-start forces or (R, 12) last policy output
    noise: np.ndarray  # (R - 1, N, nu)


class PlanOutput(NamedTuple):
    times: torch.Tensor  # (P, N) the new knot times
    candidates: torch.Tensor  # (P, R, N, nu) clipped
    rewards: torch.Tensor  # (P, R)
    knots: torch.Tensor  # (P, N, nu) the update from these rewards
    carry: torch.Tensor  # (P, R, C) the carried rollout state after the plan


class Setup(NamedTuple):
    """What a configuration fixes: its task and optimizer modules, model,
    extras and policy, and its controller, optimizer and task values."""

    task: object
    optimizer: object
    model: PhysicsModel
    extras: dict
    policy: Policy | None
    config: dict

    @property
    def nu(self) -> int:
        return int(np.asarray(self.task.warm_start(self.model, self.extras)).shape[0])

    @property
    def dt(self) -> float:
        return float(self.extras["timestep"]) * self.task.SUBSTEPS

    @property
    def num_timesteps(self) -> int:
        """The rollout length: the horizon over dt, up to a multiple of 4 steps."""
        T = int(math.ceil(self.config["controller"]["horizon"] / self.dt - 1e-9))
        return 4 * int(math.ceil(T / 4))

    def spline_ts(self) -> np.ndarray:
        c = self.config
        return np.linspace(0.0, c["controller"]["horizon"], c["optimizer_config"]["num_nodes"], endpoint=True)

    def carry_width(self) -> int:
        return 12 if self.policy is not None else max(num_constraint_rows(self.model), 1)

    def start(self, num_rollouts: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(knot times, knots, carry) of a controller's first plan: the warm
        start at every knot from time 0, the carry zero."""
        n = self.config["optimizer_config"]["num_nodes"]
        warm = np.tile(np.asarray(self.task.warm_start(self.model, self.extras), np.float64), (n, 1))
        return self.spline_ts(), warm, np.zeros((num_rollouts, self.carry_width()))


def load_setup(root: Path, config: dict, device) -> Setup:
    """The reference's pieces of ``config``: files read relative to ``root``."""
    task = importlib.import_module(f"portbench.reference.tasks.{config['task']}")
    optimizer = importlib.import_module(f"portbench.reference.optimizers.{config['optimizer']}")
    model, extras = load_snapshot(root / task.SNAPSHOT, dtype=np.float64)
    policy = None if task.POLICY is None else load_policy(root / task.POLICY, device)
    return Setup(task, optimizer, model, extras, policy, config)


def _params(values: dict, dtype, device) -> dict:
    """Numbers as tensors; flags stay Python values."""
    out = {}
    for k, v in values.items():
        out[k] = v if isinstance(v, (bool, str)) else torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                                                        device=device)
    return out


def plan(setup: Setup, inputs: list[PlanInput], dtype: torch.dtype, device) -> PlanOutput:
    """The plans of ``inputs``, computed in ``dtype`` on ``device``."""
    cfg = setup.config
    ctl = cfg["controller"]
    if ctl["max_opt_iters"] != 1 or ctl["action_normalizer"] != "none":
        raise NotImplementedError("the reference plans one optimizer iteration with no action normalizer")
    order = ctl["spline_order"]
    iters = ctl["solver_iterations"]
    opt_params = _params(cfg["optimizer_config"], dtype, device)
    task_params = _params(cfg["task_config"], dtype, device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)  # noqa: E731
    spline_ts = t(setup.spline_ts())
    rollout_ts = t(setup.dt * np.arange(setup.num_timesteps))
    bounds = setup.task.ctrl_bounds(setup.model, setup.extras)
    lo, hi = t(bounds[:, 0]), t(bounds[:, 1])

    times, cands, controls = [], [], []
    for x in inputs:
        time = t(x.time)
        new_times = time + spline_ts
        nominal = eval_spline(t(x.prev_times), t(x.prev_knots), new_times, order)
        cand = setup.optimizer.sample(opt_params, nominal, t(x.noise))
        cand = torch.minimum(torch.maximum(cand, lo), hi)
        times.append(new_times)
        cands.append(cand)
        controls.append(eval_spline(new_times, cand, time + rollout_ts, order))
    R = cands[0].shape[0]
    ctrl = torch.cat(controls)  # (P * R, T, nu)
    states0 = torch.cat([t(x.state).expand(R, -1) for x in inputs])
    carry0 = torch.cat([t(x.carry) for x in inputs])
    nq = setup.model.nq
    sim = setup.task.sim_ctrl(ctrl)
    if setup.policy is not None:
        out = policy_rollout(setup.model, setup.policy, states0[:, :nq], states0[:, nq:], sim, carry0,
                             setup.task.SUBSTEPS, iters)
    else:
        out = rollout(setup.model, states0[:, :nq], states0[:, nq:], sim, carry0, setup.task.SUBSTEPS, iters)
    rewards = setup.task.reward(out.states, out.sensors, ctrl, task_params, setup.extras).reshape(len(inputs), R)
    cand = torch.stack(cands)
    knots = torch.stack([setup.optimizer.update(opt_params, c, r) for c, r in zip(cand, rewards)])
    return PlanOutput(torch.stack(times), cand, rewards, knots, out.carry.reshape(len(inputs), R, -1))


def update(setup: Setup, candidates: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
    """The optimizer's update of each plan's candidates (P, R, N, nu) from
    the rewards (P, R) given: the update stage alone."""
    params = _params(setup.config["optimizer_config"], candidates.dtype, candidates.device)
    return torch.stack([setup.optimizer.update(params, c, r) for c, r in zip(candidates, rewards)])
