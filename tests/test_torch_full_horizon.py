"""The port's planning rollouts held against the JAX package's over their full
horizon, float64, 8 APGD iterations.

- leap: ``rollout_lanes`` against JAX ``rollout_lanes(backend="xla")``, 4
  rollouts over T 100 from onset forces of one step (a solve's carried warm
  start); states, sensors and the step-0 forces within 1e-9.
- spot_navigate: ``policy_rollout_lanes`` against JAX
  ``policy_rollout_lanes(backend="xla")``, 3 rollouts over 100 policy ticks of
  2 physics steps from a nonzero policy output; states, sensors and the last
  policy output within 1e-8, the limit of the 2-tick check
  (``test_torch_spot_physics.py``).

A branch that fires only after a contact opens, closes or slips late in the
horizon shows here and not in the short checks.

On leap the JAX narrowphase runs op by op (``unfused_narrowphase``). Compiled
by XLA into one program with the rest of the step, the JAX narrowphase can
give a contact a zero normal: capsule-box picks the inside point's nearest
face by ``gaps == min(gaps)``, and XLA's fused code can round the two sides
of that comparison apart, so no face is picked
(``test_jax_fused_narrowphase_drops_a_face``). Run op by op, every JAX
operation computes what its code says, and the port agrees with it; the
rest of the JAX step stays compiled.
"""

from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.models.leap import leap_cube_xml_path
from judo_tpu.physics import lane_collision as jlc
from judo_tpu.physics import lane_engine as jle
from judo_tpu.physics import lane_step as jls
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.pallas_step import policy_rollout_lanes as jax_policy_rollout_lanes
from judo_tpu.physics.pallas_step import rollout_lanes as jax_rollout_lanes
from judo_tpu.tasks.spot.spot_navigate import SpotNavigate as JaxSpotNavigate
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_collision as lc
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics import policy_rollout as pr
from judo_tpu_torch.physics.model import put_model
from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

from .torch_inputs import leap_batch, policy_inputs
from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

T_FULL = 100


def _unfused_find_contacts_l(m, kin):
    traced = jlc.find_contacts_l(m, kin)  # the static slot metadata; XLA drops its unused arrays
    shapes = tuple(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in (traced.dist, traced.pos, traced.normal))

    def op_by_op(k):
        c = jlc.find_contacts_l(m, jax.tree.map(jnp.asarray, k))
        return tuple(np.asarray(x) for x in (c.dist, c.pos, c.normal))

    dist, pos, normal = jax.pure_callback(op_by_op, shapes, kin)
    return traced._replace(dist=dist, pos=pos, normal=normal)


@contextmanager
def unfused_narrowphase():
    """The JAX lanes step with its narrowphase run op by op on the host
    (``jax.pure_callback``), outside XLA's fusion of the step."""
    with mock.patch.object(jls, "find_contacts_l", _unfused_find_contacts_l):
        yield


def test_leap_rollout_full_horizon_matches_jax():
    mj = mujoco.MjModel.from_xml_path(leap_cube_xml_path())
    jm = jax_put_model(mj, dtype=jnp.float64, solver_iterations=8)
    pm = put_model(mj, dtype=np.float64, solver_iterations=8)
    qp, qv, ct = leap_batch(4, T_FULL + 1, seed=21)
    qp_t, qv_t, ct_t = (torch.tensor(x) for x in (qp, qv, ct))
    warm = fr.rollout_lanes(pm, qp_t, qv_t, ct_t[:, :1], iterations=8).efc0  # onset forces from one step
    with unfused_narrowphase():
        ref = jax.jit(lambda a, b, c, f: jax_rollout_lanes(jm, a, b, c, iterations=8, backend="xla", efc_warm=f))(
            *(jnp.asarray(x) for x in (qp, qv, ct[:, 1:], warm.numpy())))
    out = fr.rollout_lanes(pm, qp_t, qv_t, ct_t[:, 1:], iterations=8, efc_warm=warm)
    assert out.states.shape == (4, T_FULL, 45) and np.abs(np.asarray(ref.efc0)).max() > 1e-2  # contacts carry force
    assert np.abs(out.states.numpy()[:, :, 26:29]).max() > 10  # the cube spins: contacts open and close
    for name in ("states", "sensordata", "efc0"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-9, rtol=0,
                                   err_msg=name)


# A leap state of the seeded batch above, 25 steps in along JAX's compiled
# trajectory of rollout 1: a finger's capsule presses into the cube.
SPLIT_QPOS = [0.06647297562625759, 0.0494930864495687, 0.08922594251646865, 0.08110840264329884, 0.41096511115274154,
              -0.6721104143618989, -0.610570794701273, 0.2320687560347389, -0.7651146237428971, 0.7238354080331789,
              0.2463845507808533, 0.16933115297959922, 0.0023797456077317386, 0.693465874564829, 0.24916690258902752,
              0.21195658310766238, 0.757392906909313, 0.700908719015959, 0.2562359874854693, 0.5613666234650468,
              0.8339501628819598, 0.7546759226331745, 0.6292939476581971]


def test_jax_fused_narrowphase_drops_a_face():
    """A reference behaviour the port does not reproduce: at this state JAX's
    narrowphase compiled by XLA gives capsule-box slot 62 (dist -1.26 cm) a
    zero normal, while the same code op by op, and the port, give it a unit
    normal (ROADMAP.md, "The reference behaves as follows")."""
    mj = mujoco.MjModel.from_xml_path(leap_cube_xml_path())
    jm = jax_put_model(mj, dtype=jnp.float64, solver_iterations=8)
    pm = put_model(mj, dtype=np.float64, solver_iterations=8)
    q = np.asarray(SPLIT_QPOS)[:, None]

    def contacts(x):
        c = jlc.find_contacts_l(jm, jle.kinematics_l(jm, x))
        return c.dist, c.normal

    fused = [np.array(x) for x in jax.jit(contacts)(jnp.asarray(q))]
    op_by_op = [np.asarray(x) for x in contacts(jnp.asarray(q))]
    port = lc.find_contacts_l(pm, le.kinematics_l(pm, torch.tensor(q)))
    np.testing.assert_allclose(port.dist.numpy(), op_by_op[0], atol=1e-12, rtol=0)
    np.testing.assert_allclose(port.normal.numpy(), op_by_op[1], atol=1e-12, rtol=0)
    np.testing.assert_allclose(fused[0], op_by_op[0], atol=1e-12, rtol=0)  # the distances agree
    assert op_by_op[0][62, 0] < -0.01 and abs(np.linalg.norm(op_by_op[1][62, :, 0]) - 1) < 1e-12
    assert np.abs(fused[1][62]).max() == 0.0  # no face picked: the fused normal is zero
    fused[1][62] = op_by_op[1][62]
    np.testing.assert_allclose(fused[1], op_by_op[1], atol=1e-12, rtol=0)  # every other slot agrees


def test_spot_policy_rollout_full_horizon_matches_jax():
    jtask = JaxSpotNavigate()
    jtask._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    task = SpotNavigate(device="cpu", dtype=torch.float64)
    qp, qv, pout, cmds = policy_inputs(task.nv, T_FULL, seed=22)
    ref = jax.jit(lambda a, b, c, d: jax_policy_rollout_lanes(
        jtask.planning_model, jtask.policy, a, b, c, d, physics_substeps=2, iterations=8, backend="xla"))(
        *(jnp.asarray(x) for x in (qp, qv, cmds, pout)))
    out = pr.policy_rollout_lanes(task.planning_model, task.policy, *(torch.tensor(x) for x in (qp, qv, cmds, pout)),
                                  2, 8)
    assert out.states.shape == (3, T_FULL, 51) and np.isfinite(out.states.numpy()).all()
    for name in ("states", "sensordata", "final_policy_output"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-8, rtol=0,
                                   err_msg=name)
