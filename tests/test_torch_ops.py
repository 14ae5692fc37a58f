"""Ops, normalizers, the leap reward and the MPPI update of the PyTorch port
held against the JAX package (and scipy), in float64 at 1e-12."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import interp1d

from judo_tpu.ops.math import quat_diff_so3 as jax_quat_diff_so3
from judo_tpu.ops.math import quat_rotate as jax_quat_rotate
from judo_tpu.ops.splines import eval_spline as jax_eval_spline
from judo_tpu.optimizers.mppi import MPPI as JaxMPPI
from judo_tpu.optimizers.mppi import MPPIConfig as JaxMPPIConfig
from judo_tpu.utils import normalization as jax_norm
from judo_tpu_torch.ops.costs import quadratic_norm, smooth_l1_norm
from judo_tpu_torch.ops.math import quat_diff_so3, quat_rotate
from judo_tpu_torch.ops.splines import eval_spline
from judo_tpu_torch.optimizers.mppi import MPPI, MPPIConfig
from judo_tpu_torch.utils import normalization as norm

TOL = 1e-12


@pytest.mark.parametrize("order", ["zero", "linear", "cubic"])
def test_splines_match_jax_and_scipy(order):
    rng = np.random.default_rng(0)
    ts = np.sort(rng.uniform(0.0, 1.0, 6))
    knots = rng.standard_normal((3, 6, 4))
    tq = np.linspace(ts[0] - 0.1, ts[-1] + 0.1, 37)
    ours = eval_spline(torch.tensor(ts), torch.tensor(knots), torch.tensor(tq), order).numpy()
    ref = np.asarray(jax_eval_spline(jnp.asarray(ts), jnp.asarray(knots), jnp.asarray(tq), order))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    fill = (knots[..., 0, :], knots[..., -1, :])
    sp = interp1d(ts, knots, kind=order, axis=-2, fill_value=fill, bounds_error=False)(tq)
    inside = (tq >= ts[0]) & (tq <= ts[-1])
    np.testing.assert_allclose(ours[:, inside], sp[:, inside], atol=TOL, rtol=0)


def test_cubic_needs_four_knots():
    with pytest.raises(ValueError, match="at least 4"):
        eval_spline(torch.tensor([0.0, 0.5, 1.0]), torch.zeros(3, 2), torch.tensor([0.2]), "cubic")


def test_quat_diff_so3_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((5, 7, 4))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = rng.standard_normal(4)
    v /= np.linalg.norm(v)
    ours = quat_diff_so3(torch.tensor(u), torch.tensor(v)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_quat_diff_so3(jnp.asarray(u), jnp.asarray(v))), atol=TOL)


@pytest.mark.parametrize("batched", ["vectors", "quaternions"])
def test_quat_rotate_matches_jax(batched):
    """One quaternion over a batch of vectors (as spot_tire_upright's reward
    uses it), and a batch of quaternions over one vector."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, 7, 4) if batched == "quaternions" else 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.standard_normal(3 if batched == "quaternions" else (5, 7, 3))
    ours = quat_rotate(torch.tensor(q), torch.tensor(v)).numpy()
    assert ours.shape == (5, 7, 3)
    np.testing.assert_allclose(ours, np.asarray(jax_quat_rotate(jnp.asarray(q), jnp.asarray(v))), atol=TOL, rtol=0)


def test_costs():
    x = torch.tensor([[3.0, 4.0], [0.0, 1.0]], dtype=torch.float64)
    np.testing.assert_allclose(quadratic_norm(x).numpy(), [12.5, 0.5])
    np.testing.assert_allclose(smooth_l1_norm(x, 1.0).numpy(), np.sqrt(x.numpy() ** 2 + 1) - 1)


@pytest.mark.parametrize("kind", ["none", "min_max", "running"])
def test_normalizers_match_jax(kind):
    rng = np.random.default_rng(2)
    cr = np.stack([-rng.uniform(0.5, 2, 5), rng.uniform(0.5, 2, 5)], axis=1)
    cr[1] = [-np.inf, np.inf]
    x = rng.standard_normal((8, 4, 5))
    with pytest.warns(UserWarning) if kind == "min_max" else contextlib.nullcontext():
        p = norm.make_normalizer_params(kind, 5, cr, dtype=torch.float64)
    with pytest.warns(UserWarning) if kind == "min_max" else contextlib.nullcontext():
        jp = jax_norm.make_normalizer_params(kind, 5, cr, dtype=jnp.float64)
    s = norm.init_normalizer_state(kind, 5, p, torch.float64)
    js = jax_norm.init_normalizer_state(kind, 5, jp, jnp.float64)
    s = norm.update_normalizer(kind, p, s, torch.tensor(x))
    js = jax_norm.update_normalizer(kind, jp, js, jnp.asarray(x))
    for f, jf in ((norm.normalize, jax_norm.normalize), (norm.denormalize, jax_norm.denormalize)):
        np.testing.assert_allclose(f(kind, p, s, torch.tensor(x)).numpy(), np.asarray(jf(kind, jp, js, jnp.asarray(x))), atol=TOL)


def test_mppi_matches_jax():
    rng = np.random.default_rng(3)
    cfg = MPPIConfig(num_rollouts=6, num_nodes=4, use_noise_ramp=True, noise_ramp=4.0, sigma=0.2, temperature=0.0025)
    jcfg = JaxMPPIConfig(num_rollouts=6, num_nodes=4, use_noise_ramp=True, noise_ramp=4.0, sigma=0.2, temperature=0.0025)
    opt, jopt = MPPI(cfg, 3), JaxMPPI(jcfg, 3)
    nominal = rng.standard_normal((4, 3))
    noise = rng.standard_normal((5, 4, 3))
    rewards = -rng.uniform(0.0, 0.01, 6)
    p = opt.params(torch.float64)
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in jopt.params().items()}
    samples, _ = opt.sample_from_noise(p, {}, torch.tensor(nominal), torch.tensor(noise))
    jsamples, _ = jopt.sample_from_noise(jp, (), jnp.asarray(nominal), jnp.asarray(noise))
    np.testing.assert_allclose(samples.numpy(), np.asarray(jsamples), atol=TOL)
    upd, _ = opt.update(p, {}, samples, torch.tensor(rewards))
    jupd, _ = jopt.update(jp, (), jsamples, jnp.asarray(rewards))
    np.testing.assert_allclose(upd.numpy(), np.asarray(jupd), atol=TOL)
    g = torch.Generator().manual_seed(0)
    s, _ = opt.sample(p, {}, torch.tensor(nominal), g)
    assert s.shape == (6, 4, 3) and torch.equal(s[0], torch.tensor(nominal))
