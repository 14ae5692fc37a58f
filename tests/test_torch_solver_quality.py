"""The accuracy of the port's contact solve (APGD with the Collatz-Wielandt
step bound), with the regimes and bounds of the JAX package's
``tests/test_physics/test_solver_quality.py``, in float64: contact-rich leap
states 30 steps into a rollout (8 rollouts), each step against a
300-iteration solve of the same state.

- warm-started at 8 iterations: within 1e-3 relative of the reference;
- cold at the planning model's iterations: within 0.8;
- warm-started from the onset forces a rollout carries: within 0.1, and
  closer than cold;
- the converged forces inside the friction cone;
- more iterations do not diverge.

Every step also runs in JAX's lanes step (``lane_step.step_l``) on the same
inputs and meets the same bound against its own reference. From a cold start
at 8, 25 and 100 iterations the port's step outputs equal JAX's within 1e-9.
Where APGD's restart sum grad . (f_new - f) is rounding noise, the two
restart at different iterations and part: from forces that are already
converged (the warm starts here, by 1e-9), and in the 300-iteration solves,
which converge slowly on these states (by up to 3e-7) (ROADMAP.md, "The
reference behaves as follows"). Those are held to their bounds on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from judo_tpu.physics import lane_step as jls
from judo_tpu.tasks.leap_cube import LeapCube as JaxLeapCube
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_collision as lc
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics import lane_step as ls
from judo_tpu_torch.physics.model import num_noncontact_rows
from judo_tpu_torch.tasks.leap_cube import LeapCube

from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class Steps:
    """One step of the port and of JAX from the same (nq, B) state, control
    and warm forces (zero: a cold start), at a given number of iterations."""

    def __init__(self, jm, pm, qp, qv, ctrl):
        self.pm, self.qv = pm, qv
        self.args = [torch.tensor(x) for x in (qp, qv, ctrl)]
        jargs = [jnp.asarray(x) for x in (qp, qv, ctrl)]
        self._jax = jax.jit(lambda f, it: jls.step_l(jm, *jargs, f, solver_iterations=it, lipschitz="cw"),
                            static_argnums=1)
        self.cold = np.zeros((ls.num_constraint_rows(pm), qp.shape[1]))

    def __call__(self, f, iterations):
        """(port, JAX) step outputs as (qvel, efc_force) pairs of arrays."""
        out = ls.step_l(self.pm, *self.args, torch.tensor(f), iterations)
        ref = self._jax(jnp.asarray(f), iterations)
        return (out.qvel.numpy(), out.efc_force.numpy()), (np.asarray(ref.qvel), np.asarray(ref.efc_force))

    def rel(self, qvel, ref_qvel) -> float:
        """Largest |dv - dv_ref| over the largest |dv_ref|, dv = qvel' - qvel."""
        dv_ref = ref_qvel - self.qv
        return float(np.abs((qvel - self.qv) - dv_ref).max() / max(np.abs(dv_ref).max(), 1e-9))

    def same_cold(self, iterations) -> tuple:
        """A cold step of each, equal within 1e-9."""
        ours, theirs = self(self.cold, iterations)
        for name, a, b in zip(("qvel", "efc_force"), ours, theirs):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f"{name} at {iterations} iterations")
        return ours, theirs


def _rollout_end(pm, task, B, seed):
    rng = np.random.default_rng(seed)
    warm = np.asarray(task.optimizer_warm_start(), np.float64)
    qp0 = np.tile(task.data.qpos, (B, 1))
    ct = warm[None, None] + 0.05 * rng.standard_normal((B, 30, pm.nu))
    out = fr.rollout_lanes(pm, torch.tensor(qp0), torch.zeros((B, pm.nv), dtype=torch.float64), torch.tensor(ct))
    states = out.states[:, -1].numpy()
    return states[:, : pm.nq], states[:, pm.nq :], ct


@pytest.fixture(scope="module")
def mid_rollout_state():
    """Contact-rich states 30 steps into a leap rollout (8 rollouts), the
    JAX and port planning models (float64) and the 300-iteration reference."""
    task = JaxLeapCube()
    task._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    jm, pm = task.planning_model, LeapCube(device="cpu", dtype=torch.float64).planning_model
    assert pm.solver_iterations == jm.solver_iterations
    qp, qv, ct = _rollout_end(pm, task, 8, seed=0)
    steps = Steps(jm, pm, qp.T.copy(), qv.T.copy(), ct[:, -1].T.copy())
    return task, jm, pm, steps, steps(steps.cold, 300)


def test_warm_started_tracking_accuracy(mid_rollout_state):
    *_, steps, refs = mid_rollout_state
    for ref, out in zip(refs, steps(refs[0][1], 8)):  # the port, then JAX, each from its own reference
        rel = steps.rel(out[0], ref[0])
        assert rel < 1e-3, f"warm-started relative dv error {rel:.2e} >= 1e-3"


def test_cold_start_bounded(mid_rollout_state):
    _, _, pm, steps, refs = mid_rollout_state
    for ref, out in zip(refs, steps.same_cold(max(pm.solver_iterations, 8))):
        rel = steps.rel(out[0], ref[0])
        assert np.isfinite(rel) and rel < 0.8, f"cold-start relative dv error {rel:.3f} >= 0.8"


def test_cross_solve_efc_warm_carry(mid_rollout_state):
    """The onset forces a rollout returns (efc0) as the next solve's warm
    start: warm-starting the onset step from them tracks the 300-iteration
    reference within 0.1, closer than cold."""
    task, jm, pm, _, _ = mid_rollout_state
    qp1, qv1, ct = _rollout_end(pm, task, 4, seed=1)
    t = torch.tensor
    out1 = fr.rollout_lanes(pm, t(qp1), t(qv1), t(ct[:, :5]))
    assert float(out1.efc0.abs().max()) > 1e-6  # the grasp carries forces
    out2 = fr.rollout_lanes(pm, t(qp1), t(qv1), t(ct[:, :5]), efc_warm=out1.efc0)
    assert np.isfinite(out2.states.numpy()).all()
    steps = Steps(jm, pm, qp1.T.copy(), qv1.T.copy(), ct[:, 0].T.copy())
    refs = steps(steps.cold, 300)
    colds = steps.same_cold(8)
    warms = steps(out1.efc0.T.numpy(), 8)
    for ref, cold, warm in zip(refs, colds, warms):  # the port, then JAX
        rel_cold, rel_warm = steps.rel(cold[0], ref[0]), steps.rel(warm[0], ref[0])
        assert rel_warm < rel_cold, (rel_warm, rel_cold)
        assert rel_warm < 0.1, f"warm onset rel {rel_warm:.2e} (>= 0.1)"


@pytest.mark.parametrize("side", ["port", "jax"])
def test_converged_forces_respect_friction_cone(mid_rollout_state, side):
    """The 300-iteration forces, ||f_t|| <= mu f_n per contact."""
    task, _, pm, steps, refs = mid_rollout_state
    assert not pm.cone_pyramidal
    f = refs[0 if side == "port" else 1][1]
    n0 = num_noncontact_rows(pm)
    nc = (f.shape[0] - n0) // 3
    kin = le.kinematics_l(pm, torch.tensor(np.tile(task.data.qpos, (4, 1)).T.copy()))
    mus = np.asarray(lc.find_contacts_l(pm, kin).friction, np.float64)
    assert mus.shape[0] == nc
    fn = f[n0 : n0 + nc]
    ft = np.sqrt(f[n0 + nc : n0 + 2 * nc] ** 2 + f[n0 + 2 * nc :] ** 2)
    viol = (ft - mus[:, None] * fn) / np.maximum(mus[:, None] * np.abs(fn), 1e-6)
    assert fn.min() >= -1e-5, "normal forces must be nonnegative"
    assert viol.max() < 1e-3, f"friction-cone violation {viol.max():.2%} (>=0.1%)"


def test_more_iterations_do_not_diverge(mid_rollout_state):
    *_, steps, refs = mid_rollout_state
    for ref, lo, hi in zip(refs, steps.same_cold(25), steps.same_cold(100)):
        e_lo, e_hi = steps.rel(lo[0], ref[0]), steps.rel(hi[0], ref[0])
        assert np.isfinite(e_lo) and np.isfinite(e_hi)
        assert e_hi <= e_lo + 1e-6
