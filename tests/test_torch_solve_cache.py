"""The PyTorch port's solve cache (``Controller._get_solve``, one
``SolveGraph`` per shape signature), on the CPU, where an entry runs the eager
``solve`` on its static buffers.

- Every value a solve bakes in changes the signature, ``noise_ramp`` among
  them; parameter values (sigma, temperature, a reward weight, the horizon
  inside its 4-step bucket) do not.
- A -> B -> A reuses A's entry; 17 signatures leave 16 entries, the least
  recently used evicted.
- The entry's buffer path on cylinder_push + PS (8 rollouts, 4 knots, 0.2 s,
  float64) equals the eager ``solve`` from the same seed, bitwise, over six
  solves with tunes, a horizon change, a reset and then ``full_outputs`` at
  pipeline depth 2, where an in-flight solve's outputs stay as they were.
- Every key of the JAX ``Controller._signature`` has its counterpart.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from judo_tpu.controller import make_controller as jax_make_controller
from judo_tpu_torch.controller import Controller, ControllerConfig, make_controller
from judo_tpu_torch.controller.controller import solve
from judo_tpu_torch.controller.solve_graph import SolveGraph, draw_noise
from judo_tpu_torch.tasks import get_registered_tasks

R, N, H = 8, 4, 0.2
# The JAX package's _signature, position by position (judo_tpu/controller/controller.py:293-315).
JAX_SIGNATURE = (
    "optimizer", "stop_cond", "num_rollouts", "num_nodes", "use_noise_ramp", "spline_order", "num_timesteps",
    "max_opt_iters", "action_normalizer", "num_trace_elites", "rollout_backend", "solver_iterations", "full_outputs",
    "physics_substeps", "uses_locomotion_policy", "ctrlrange", "extra",
)


@pytest.fixture(autouse=True)
def empty_cache():
    Controller._solve_cache.clear()
    yield
    Controller._solve_cache.clear()


def _controller(task: str = "cylinder_push", opt: str = "ps", dtype=torch.float64):
    np.random.seed(0)  # cylinder_push's reset draws its start from numpy's global state
    c = make_controller(task, opt, device="cpu", dtype=dtype, seed=0)
    c.optimizer_cfg.num_rollouts, c.optimizer_cfg.num_nodes = R, N
    c.controller_cfg.horizon = H
    c._sync_state_shapes()
    return c


def _sig(c) -> dict:
    return dict(c._signature(c._solve_inputs()[1]))


def _with_task(task, opt: str = "ps"):
    """A controller of ``task`` (a task object) with the registry's optimizer ``opt``."""
    from judo_tpu_torch.optimizers import get_registered_optimizers

    opt_cls, cfg_cls = get_registered_optimizers()[opt]
    return Controller(ControllerConfig(), task, opt_cls(cfg_cls(), task.nu), seed=0)


def _cylinder_push():
    return get_registered_tasks()["cylinder_push"][0](device="cpu", dtype=torch.float64)


def _set(obj, name, value):
    setattr(obj, name, value)


# name -> (what changes, the keys that must differ). Each changes one controller in place.
MUTATIONS = {
    "stop_cond": (lambda c, mp: _set(c.optimizer, "stop_cond", lambda: True), {"stop_cond"}),
    "max_opt_iters": (lambda c, mp: _set(c.controller_cfg, "max_opt_iters", 2), {"max_opt_iters"}),
    "spline_order": (lambda c, mp: _set(c.controller_cfg, "spline_order", "linear"), {"spline_order"}),
    "normalizer": (lambda c, mp: _set(c.controller_cfg, "action_normalizer", "running"),
                   {"action_normalizer", "normalizer_kind"}),
    "num_trace_elites": (lambda c, mp: _set(c.controller_cfg, "max_num_traces", 2), {"num_trace_elites"}),
    "trace_sensors": (lambda c, mp: _set(c.task, "extras", {**c.task.extras, "trace_sensor_adr": np.array([0])}),
                      {"trace_inds"}),
    "physics_substeps": (lambda c, mp: mp.setattr(type(c.task), "physics_substeps", property(lambda self: 2)),
                         {"physics_substeps"}),
    "solver_iterations": (lambda c, mp: _set(c.controller_cfg, "solver_iterations", 12), {"solver_iterations"}),
    "full_outputs": (lambda c, mp: _set(c.controller_cfg, "full_outputs", True), {"full_outputs"}),
    "post_rollout": (lambda c, mp: mp.setattr(type(c.task), "post_rollout", lambda self, *a, **k: None),
                     {"post_rollout"}),
    "use_noise_ramp": (lambda c, mp: _set(c.optimizer_cfg, "use_noise_ramp", not c.optimizer_cfg.use_noise_ramp),
                       {"use_noise_ramp"}),
    "noise_ramp": (lambda c, mp: _set(c.optimizer_cfg, "noise_ramp", 2 * c.optimizer_cfg.noise_ramp),
                   {"noise_ramp"}),
    "num_nodes": (lambda c, mp: _set(c.optimizer_cfg, "num_nodes", N + 1), {"num_nodes"}),
    "num_rollouts": (lambda c, mp: _set(c.optimizer_cfg, "num_rollouts", R + 1), {"num_rollouts"}),
    "num_timesteps": (lambda c, mp: _set(c.controller_cfg, "horizon", 2 * H), {"num_timesteps"}),
    "device": (lambda c, mp: _set(c, "device", torch.device("cuda")), {"device"}),
    "metadata": (lambda c, mp: _set(c, "system_metadata", {"goal": np.zeros(2)}), {"inputs"}),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_baked_value_changes_signature(name, monkeypatch):
    mutate, keys = MUTATIONS[name]
    c = _controller()
    before = _sig(c)
    if name == "device":  # the signature only reads it; staging for the card needs a card
        inputs = c._solve_inputs()[1]
        mutate(c, monkeypatch)
        after = dict(c._signature(inputs))
    else:
        mutate(c, monkeypatch)
        after = _sig(c)
    changed = {k for k in before if before[k] != after[k]}
    assert keys <= changed, (name, changed)


def _pm_variant():
    t = _cylinder_push()
    pm = t.planning_model
    t.planning_model = dataclasses.replace(pm, body_mass=pm.body_mass * 1.5, _packed={})
    return t


def _spot_policy_variant():
    t = get_registered_tasks()["spot_navigate"][0](device="cpu", dtype=torch.float64)
    t.policy = copy.deepcopy(t.policy)
    with torch.no_grad():
        t.policy.layers[0].weight[0, 0] += 0.5
    return t


# name -> (make the first controller, make the second, the keys that must differ)
PAIRS = {
    "optimizer": (lambda: _controller(opt="ps"), lambda: _controller(opt="mppi"), {"optimizer", "optimizer_class"}),
    "num_elites": (lambda: _controller(opt="cem"), lambda: _num_elites(_controller(opt="cem"), 3), {"extra"}),
    "dtype": (lambda: _controller(), lambda: _controller(dtype=torch.float32), {"dtype"}),
    "task": (lambda: _controller(), lambda: _controller(task="cartpole"), {"task", "model"}),
    "model": (lambda: _with_task(_cylinder_push()), lambda: _with_task(_pm_variant()), {"model"}),
    "spot_policy": (lambda: _with_task(get_registered_tasks()["spot_navigate"][0](device="cpu",
                                                                                  dtype=torch.float64), "mppi"),
                    lambda: _with_task(_spot_policy_variant(), "mppi"), {"policy"}),
    "leap_goal": (lambda: _controller(task="leap_cube", opt="mppi"),
                  lambda: _leap_goal(_controller(task="leap_cube", opt="mppi")), {"task"}),
}


def _num_elites(c, n):
    c.optimizer_cfg.num_elites = n
    return c


def _leap_goal(c):
    c.task.goal_pos = c.task.goal_pos + 0.01
    return c


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_baked_value_of_another_controller_changes_signature(name):
    make_a, make_b, keys = PAIRS[name]
    a, b = _sig(make_a()), _sig(make_b())
    changed = {k for k in a if a[k] != b[k]}
    assert keys <= changed, (name, changed)
    if name == "spot_policy":
        assert a["uses_locomotion_policy"] and a["rollout_backend"] == "fused_policy_rollout"


def test_parameter_values_keep_signature():
    c = _controller(opt="mppi")
    before = _sig(c)
    c.optimizer_cfg.sigma *= 1.5
    c.optimizer_cfg.temperature *= 2.0
    c.task.config.w_cart_position *= 3.0
    c.task.config.goal_pos = np.array([0.3, -0.2])
    c.controller_cfg.horizon = H + 0.02  # T 10 -> 11, both in the bucket of 12
    assert c.num_timesteps == 12
    c.current_state = c.current_state + 0.1
    assert _sig(c) == before


def test_switch_back_reuses_entry_and_keeps_other_carries():
    builds, captures = SolveGraph.builds, SolveGraph.captures
    a = _controller()
    a.update_action()
    b = _controller(task="cartpole")
    b.update_action()
    a_carry = [x.clone() for x in (a._carry.times, a._carry.nominal_knots, a._carry.efc_warm)]
    a2 = _controller()
    a2.current_state = a2.current_state + 0.05
    a2.update_action()
    assert SolveGraph.builds - builds == 2
    assert len(Controller._solve_cache) == 2
    # a2's solve ran on a's entry; a's carry was cloned off the buffers first
    for x, y in zip(a_carry, (a._carry.times, a._carry.nominal_knots, a._carry.efc_warm)):
        assert torch.equal(x, y)
    a.update_action()  # and a takes the entry back
    assert SolveGraph.builds - builds == 2 and SolveGraph.captures == captures  # no graph on the CPU


def test_lru_keeps_sixteen_and_evicts_oldest():
    c = _controller()
    entries = {}

    def entry(r):
        c.optimizer_cfg.num_rollouts = r
        c._sync_state_shapes()
        return c._get_solve(c._solve_inputs()[1])

    for r in range(2, 18):  # 16 signatures
        entries[r] = entry(r)
    assert len(Controller._solve_cache) == Controller._SOLVE_CACHE_MAX == 16
    assert entry(2) is entries[2]  # a hit refreshes its place: 3 is now the oldest
    entries[18] = entry(18)
    cached = list(Controller._solve_cache.values())
    assert len(cached) == 16
    assert entries[3] not in cached and entries[2] in cached and entries[18] is cached[-1]
    assert entry(3) is not entries[3]  # evicted: made again


class _EagerSolve:
    """The plain ``solve`` in place of a cache entry, its noise drawn from the
    carry's generator as an entry draws it."""

    def __call__(self, ctrl, carry, inputs):
        return solve(ctrl, carry, *inputs, draw_noise(ctrl, carry.generator))


def _published(c) -> list:
    for f in c._consume_futures:
        f.result()
    traces = np.zeros(0) if c.traces is None else c.traces
    return [c.times.copy(), c.nominal_knots.copy(), c.rewards.copy(), traces.copy()]


def _carry(c) -> list:
    k = c._carry
    return [k.times, k.nominal_knots, k.efc_warm, *(k.opt_state or {}).values()]


def _assert_same(a, b, what: str) -> None:
    assert _published(a) is not None
    for x, y in zip(_published(a), _published(b)):
        np.testing.assert_array_equal(x, y, err_msg=what)
    for x, y in zip(_carry(a), _carry(b)):
        assert torch.equal(x, y), what


def test_entry_matches_eager_solve_bitwise():
    builds = SolveGraph.builds
    cached, eager = _controller(), _controller()
    eager._get_solve = lambda inputs: _EagerSolve()
    rng = np.random.default_rng(3)
    edits = {
        1: lambda c: setattr(c.optimizer_cfg, "sigma", 1.5 * c.optimizer_cfg.sigma),
        2: lambda c: setattr(c.task.config, "w_cart_position", 2.0 * c.task.config.w_cart_position),
        3: lambda c: setattr(c.controller_cfg, "horizon", H + 0.02),
        4: lambda c: (np.random.seed(1), c.reset()),
    }
    for n in range(5):
        state = np.r_[0.5 * rng.standard_normal(4), 0.2 * rng.standard_normal(4)]
        for c in (cached, eager):
            if n in edits:
                edits[n](c)
            c.current_state, c.time = state.copy(), 0.02 * n
            c.update_action()
        _assert_same(cached, eager, f"solve {n}")
    assert SolveGraph.builds - builds == 1  # tunes, the horizon in its bucket and the reset keep the entry
    # full outputs at depth 2: a new signature; an in-flight solve's outputs stay as they were
    for c in (cached, eager):
        c.controller_cfg.full_outputs, c.controller_cfg.pipeline_depth = True, 2
    held = None
    for n in range(5, 9):
        state = np.r_[0.5 * rng.standard_normal(4), 0.2 * rng.standard_normal(4)]
        for c in (cached, eager):
            c.current_state, c.time = state.copy(), 0.02 * n
            c.update_action()
        if n == 5:
            held = cached._pending[0].outputs
            kept = [x.clone() for x in held]
    assert SolveGraph.builds - builds == 2
    assert all(torch.equal(x, y) for x, y in zip(held, kept))
    for c in (cached, eager):
        c.flush_pipeline()
    _assert_same(cached, eager, "flushed at depth 2")
    for x, y in zip(cached.last_outputs, eager.last_outputs):
        assert torch.equal(x, y)
    assert cached.last_outputs.states.shape == (R, 12, 8)


def test_signature_covers_jax_signature():
    ref = jax_make_controller("cylinder_push", "cem")  # built, not solved
    ours = make_controller("cylinder_push", "cem", device="cpu", dtype=torch.float32, seed=0)
    for cfg, jcfg in ((ours.controller_cfg, ref.controller_cfg), (ours.optimizer_cfg, ref.optimizer_cfg)):
        for f in dataclasses.fields(cfg):  # the same configuration on both sides
            setattr(jcfg, f.name, getattr(cfg, f.name))
    jax_sig = ref._signature()
    assert len(jax_sig) == len(JAX_SIGNATURE)
    sig = _sig(ours)
    assert "noise_ramp" in sig  # read by the solve; the JAX key leaves it out
    for name, value in zip(JAX_SIGNATURE, jax_sig):
        assert name in sig, name
        if name != "rollout_backend":  # the JAX package names its backend, the port its kernel
            assert sig[name] == value, (name, sig[name], value)
