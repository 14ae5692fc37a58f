"""Predictive sampling and the cross-entropy method of the PyTorch port, and
every per-task optimizer and controller default, held against the JAX
package.

Both sides get the same numpy noise through ``sample_from_noise``. Sampling,
updates (including tied rewards, where both pick the lower index first),
initial state and the re-interpolation of CEM's sigma onto a new knot grid
agree within 1e-12 in float64; the override values are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.controller.overrides import set_default_controller_overrides as jax_controller_overrides
from judo_tpu.optimizers import get_registered_optimizers as jax_registered_optimizers
from judo_tpu.optimizers.overrides import set_default_optimizer_overrides as jax_optimizer_overrides
from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks
from judo_tpu_torch.controller import ControllerConfig, make_controller
from judo_tpu_torch.controller.overrides import set_default_controller_overrides
from judo_tpu_torch.optimizers import get_registered_optimizers
from judo_tpu_torch.optimizers.base import top_k_indices
from judo_tpu_torch.optimizers.overrides import set_default_optimizer_overrides

R, N, NU = 9, 4, 3


def _pair(name: str, **cfg):
    """(port optimizer, JAX optimizer) of registry name ``name`` with ``cfg``."""
    cls, cfg_cls = get_registered_optimizers()[name]
    jcls, jcfg_cls = jax_registered_optimizers()[name]
    return cls(cfg_cls(**cfg), NU), jcls(jcfg_cls(**cfg), NU)


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


def _rewards(rng, tied: bool) -> np.ndarray:
    r = rng.standard_normal(R)
    if tied:  # the best value three times, and a tie among the rest
        r[[2, 5, 7]] = r.max() + 1.0
        r[[0, 8]] = r[1]
    return r


@pytest.mark.parametrize("ramp", [False, True])
@pytest.mark.parametrize("name", ["ps", "cem"])
def test_sample_from_noise_matches_jax(name, ramp):
    extra = {"sigma": 0.3} if name == "ps" else {"sigma_min": 0.05, "sigma_max": 0.8, "num_elites": 3}
    ours, ref = _pair(name, num_rollouts=R, num_nodes=N, use_noise_ramp=ramp, noise_ramp=3.0, **extra)
    rng = np.random.default_rng(1)
    nominal, noise = rng.standard_normal((N, NU)), rng.standard_normal((R - 1, N, NU))
    state = ours.init_state(torch.float64)
    jstate = ref.init_state(jnp.float64)
    if name == "cem":  # a sigma that the ramp pushes past both clips
        sig = rng.uniform(0.0, 0.5, (N, NU))
        state, jstate = {"sigma": torch.tensor(sig)}, {"sigma": jnp.asarray(sig)}
    s, st = ours.sample_from_noise(ours.params(torch.float64), state, torch.tensor(nominal), torch.tensor(noise))
    js, jst = ref.sample_from_noise(ref.params(), jstate, jnp.asarray(nominal), jnp.asarray(noise))
    assert s.shape == (R, N, NU) and np.array_equal(s[0].numpy(), nominal)
    _close(s, js)
    for k in st:
        _close(st[k], jst[k])


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("name", ["ps", "cem"])
def test_update_matches_jax(name, tied):
    extra = {} if name == "ps" else {"sigma_min": 0.05, "sigma_max": 0.8, "num_elites": 3}
    ours, ref = _pair(name, num_rollouts=R, num_nodes=N, **extra)
    rng = np.random.default_rng(2 + tied)
    samples, rewards = rng.standard_normal((R, N, NU)), _rewards(rng, tied)
    nom, st = ours.update(ours.params(torch.float64), ours.init_state(torch.float64), torch.tensor(samples),
                          torch.tensor(rewards))
    jnom, jst = ref.update(ref.params(), ref.init_state(jnp.float64), jnp.asarray(samples), jnp.asarray(rewards))
    _close(nom, jnom)
    for k in st:
        _close(st[k], jst[k])
    if tied and name == "ps":
        assert np.array_equal(nom.numpy(), samples[2])  # the first of the tied best


def test_top_k_order_matches_jax_on_ties():
    import jax

    rng = np.random.default_rng(4)
    r = _rewards(rng, True)
    for k in (1, 3, 5, R):
        assert top_k_indices(torch.tensor(r), k).tolist() == np.asarray(jax.lax.top_k(jnp.asarray(r), k)[1]).tolist()


def test_cem_state_and_reinterpolation_match_jax():
    ours, ref = _pair("cem", num_rollouts=R, num_nodes=N, sigma_min=0.1, sigma_max=0.7)
    _close(ours.init_state(torch.float64)["sigma"], ref.init_state(jnp.float64)["sigma"], 0.0)
    assert ours.init_state(torch.float64)["sigma"].shape == (N, NU)
    rng = np.random.default_rng(5)
    sig = rng.uniform(0.1, 0.7, (N, NU))
    old_t, new_t = np.linspace(0.3, 1.3, N), np.linspace(0.25, 1.4, 6)  # extrapolates past both ends
    st = ours.pre_optimization(ours.params(torch.float64), {"sigma": torch.tensor(sig)}, torch.tensor(old_t),
                               torch.tensor(new_t))
    jst = ref.pre_optimization(ref.params(), {"sigma": jnp.asarray(sig)}, jnp.asarray(old_t), jnp.asarray(new_t))
    assert st["sigma"].shape == (6, NU)
    _close(st["sigma"], jst["sigma"])
    same = ours.pre_optimization(ours.params(torch.float64), {"sigma": torch.tensor(sig)}, torch.tensor(old_t),
                                 torch.tensor(old_t))
    assert np.array_equal(same["sigma"].numpy(), sig)


def test_controller_resizes_cem_state():
    """A change of num_nodes re-interpolates the nominal knots and sigma onto
    the new knot times; a change of num_rollouts leaves sigma as it is."""
    c = make_controller("cylinder_push", "cem", device="cpu", dtype=torch.float64, seed=0)
    c._carry.opt_state = {"sigma": torch.linspace(0.2, 0.5, 4, dtype=torch.float64)[:, None].repeat(1, 2)}
    c.optimizer_cfg.num_nodes = 7
    c.optimizer_cfg.num_rollouts = 5
    c._sync_state_shapes()
    assert c._carry.nominal_knots.shape == (7, 2) and c._carry.efc_warm.shape[0] == 5
    np.testing.assert_allclose(c._carry.opt_state["sigma"][:, 0].numpy(), np.linspace(0.2, 0.5, 7), atol=1e-12)
    c.update_action()
    assert np.all(np.isfinite(c.rewards)) and c.rewards.shape == (5,)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_overrides_match_jax():
    """Every per-task default of the JAX package, for every task and all
    three optimizers, and the controller's."""
    set_default_optimizer_overrides()
    set_default_controller_overrides()
    jax_optimizer_overrides()
    jax_controller_overrides()
    for task in jax_registered_tasks():
        for name, (_, cfg_cls) in get_registered_optimizers().items():
            ours, ref = cfg_cls(), jax_registered_optimizers()[name][1]()
            ours.set_override(task)
            ref.set_override(task)
            assert _fields(ours) == _fields(ref), (task, name)
        ours, ref = ControllerConfig(), JaxControllerConfig()
        ours.set_override(task)
        ref.set_override(task)
        assert _fields(ours) == _fields(ref), task
    assert sorted(get_registered_optimizers()) == sorted(jax_registered_optimizers()) == ["cem", "mppi", "ps"]
