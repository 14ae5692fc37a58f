"""One planning solve each of spot_tire_roll and spot_tire_upright in the
PyTorch port against the JAX ``Controller`` on its lanes path
(``lanes_xla``), as ``test_torch_spot_tasks.py`` holds spot_box_push's: float64,
4 rollouts, the horizon cut to 0.08 s, shared noise; rewards, knots, traces
and the carried policy output within 1e-6. The tire scene's plane-cylinder,
capsule-cylinder and sphere-cylinder pairs run in both solves.
"""

import jax.numpy as jnp
import pytest

from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks

from .test_torch_spot_tasks import assert_solve_matches_jax


@pytest.mark.parametrize("name", ["spot_tire_roll", "spot_tire_upright"])
def test_update_action_matches_jax_controller(name):
    ref = jax_registered_tasks()[name][0]()
    ref._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    assert_solve_matches_jax(name, ref)
