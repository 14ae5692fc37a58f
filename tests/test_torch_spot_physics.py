"""The Spot slice's physics in the PyTorch port held against the JAX package:
the plane narrowphase kernels, pyramidal-cone assembly and the orthant dual
solve, one step on the Spot planning model, the policy-in-the-loop rollout,
and the CUDA kernels' own arithmetic (built with g++) against the plain
versions.

Tolerances (float64): plane kernels 1e-12 (op by op); assembly, dual solve
and one step 1e-9; the policy rollout 1e-8 over 2 ticks of 2 steps; host
twins 1e-9 (measured ~1e-14).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.models.spot import build_spot_xml
from judo_tpu.physics import lane_collision as jlc
from judo_tpu.physics import lane_engine as jle
from judo_tpu.physics import lane_step as jls
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.pallas_step import policy_rollout_lanes as jax_policy_rollout_lanes
from judo_tpu.tasks.spot.spot_base import _spot_planner_pairs as jax_spot_pairs
from judo_tpu.tasks.spot.spot_navigate import SpotNavigate as JaxSpotNavigate
from judo_tpu_torch.models.leap import leap_cube_xml
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_collision as lc
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics import lane_step as ls
from judo_tpu_torch.physics import policy_rollout as pr
from judo_tpu_torch.physics.model import num_constraint_rows, put_model
from judo_tpu_torch.tasks.leap_cube import QPOS_REST
from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.spot_base import _spot_planner_pairs
from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

from .test_physics.test_parity import CARTPOLE
from .test_torch_physics import _random_frames
from .torch_inputs import STAND, TARGETS, policy_inputs

R = 3


@pytest.fixture(scope="module")
def spot():
    """JAX and port planning models of spot_navigate (float64, 8 iterations)
    and R states that sink the feet 3 cm into the ground."""
    mj = mujoco.MjModel.from_xml_string(build_spot_xml())
    jm = jax_put_model(mj, dtype=jnp.float64, solver_iterations=8, collision_pair_filter=jax_spot_pairs)
    pm = put_model(mj, dtype=np.float64, solver_iterations=8, collision_pair_filter=_spot_planner_pairs)
    rng = np.random.default_rng(0)
    qp = np.tile(STAND, (R, 1)).T.copy()
    qp[2] -= 0.03
    qp[7:] += 0.05 * rng.standard_normal((pm.nq - 7, R))
    qv = 0.1 * rng.standard_normal((pm.nv, R))
    ctrl = TARGETS[:, None] + 0.05 * rng.standard_normal((pm.nu, R))
    return jm, pm, qp, qv, ctrl


def test_spot_model_counts(spot):
    _, pm, *_ = spot
    assert pm.cone_pyramidal and (pm.nq, pm.nv, pm.nu, pm.nsensordata) == (26, 25, 19, 48)
    # first-seen pair type order: plane-box (body), plane-capsule (legs), plane-sphere (feet)
    assert [(sig, len(p)) for sig, p in lc.pair_groups(pm)] == [((0, 6), 6), ((0, 3), 16), ((0, 2), 5)]
    assert num_constraint_rows(pm) == 38 + 4 * 61 == 282


@pytest.mark.parametrize("kind", ["plane_sphere", "plane_capsule", "plane_box"])
def test_plane_kernels_match_jax(kind):
    """Op by op against lane_collision._k_<kind>, random poses and sizes."""
    rng = np.random.default_rng({"plane_sphere": 21, "plane_capsule": 22, "plane_box": 23}[kind])
    P, B = 4, 48
    x1 = 0.1 * rng.standard_normal((P, 3, B))
    x2 = 0.1 * rng.standard_normal((P, 3, B))
    m1, m2 = _random_frames(rng, P, B), _random_frames(rng, P, B)
    s1 = np.tile([5.0, 5.0, 0.1], (P, 1))
    s2 = rng.uniform(0.02, 0.1, (P, 3))
    jk, tk = getattr(jlc, f"_k_{kind}"), getattr(lc, f"_k_{kind}")
    cols = lambda s: tuple(jnp.asarray(s[:, k : k + 1]) for k in range(3))  # noqa: E731
    ref = jk(jnp.asarray(x1), jnp.asarray(m1), cols(s1), jnp.asarray(x2), jnp.asarray(m2), cols(s2))
    ours = tk(*(torch.tensor(x) for x in (x1, m1, s1, x2, m2, s2)))
    assert len(ours) == len(ref) == {"plane_sphere": 1, "plane_capsule": 2, "plane_box": 4}[kind]
    assert (ours[0][0].numpy() < 0).mean() > 0.2 and (ours[-1][0].numpy() > 0).mean() > 0.2
    for s, ((d, p, n), (jd, jp, jn)) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-12, rtol=0, err_msg=f"dist slot {s}")
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-12, rtol=0, err_msg=f"pos slot {s}")
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-12, rtol=0, err_msg=f"normal slot {s}")


def test_pyramidal_assembly_and_step_match_jax(spot):
    """Contacts, the 282 pyramidal rows and one full step (cold probe), float64."""
    jm, pm, qp, qv, ctrl = spot

    @jax.jit
    def ref(q, v, u):
        kin = jle.kinematics_l(jm, q)
        c = jlc.find_contacts_l(jm, kin)
        rows = jls.assemble_constraints_l(jm, jle.com_l(jm, kin), c, q, v)
        return (c.dist, c.pos), tuple(rows), jls.step_l(jm, q, v, u, None, solver_iterations=8)

    (jd, jp), jrows, jstep = ref(*(jnp.asarray(x) for x in (qp, qv, ctrl)))
    q, v = torch.tensor(qp), torch.tensor(qv)
    kin = le.kinematics_l(pm, q)
    c = lc.find_contacts_l(pm, kin)
    np.testing.assert_allclose(c.dist.numpy(), np.asarray(jd), atol=1e-9, rtol=0)
    np.testing.assert_allclose(c.pos.numpy(), np.asarray(jp), atol=1e-9, rtol=0)
    rows = ls.assemble_constraints_l(pm, le.com_l(pm, kin), c, q, v)
    assert rows.J.shape == (282, 25, R) and float(rows.active.sum()) > 0
    for name, a, b in zip(rows._fields, rows, jrows):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9, rtol=0, err_msg=name)
    out = ls.step_l(pm, q, v, torch.tensor(ctrl), None, 8)
    assert np.abs(np.asarray(jstep.efc_force)).max() > 1.0  # the feet carry the robot
    for name in ("qpos", "qvel", "sensordata", "efc_force", "cw_v"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(jstep, name)), atol=1e-9, rtol=0, err_msg=name
        )


def test_dual_solve_orthant_matches_jax():
    """mus=None (pyramidal facets): the projection is onto the orthant."""
    rng = np.random.default_rng(8)
    nv, B, nefc = 7, 6, 20
    J = rng.standard_normal((nefc, nv, B))
    a = rng.standard_normal((nv, nv, B))
    spd = np.einsum("ikb,jkb->ijb", a, a) + nv * np.eye(nv)[:, :, None]
    blocks = [(0, np.linalg.inv(spd.transpose(2, 0, 1)).transpose(1, 2, 0))]
    reg, b = rng.uniform(0.01, 0.1, (nefc, B)), rng.standard_normal((nefc, B))
    diag, f_warm, cw_v = rng.uniform(0.5, 2.0, (nefc, B)), np.abs(rng.standard_normal((nefc, B))), None
    jf, jv = jax.jit(
        lambda J_, r_, b_, d_, fw: jls.solve_dual_qp_l(
            J_, [(0, jnp.asarray(blocks[0][1]))], r_, b_, 8, fw, "cw", ncon_start=0, mus=None, diag=d_, cw_v=cw_v
        )
    )(*(jnp.asarray(x) for x in (J, reg, b, diag, f_warm)))
    t = torch.tensor
    f, v = ls.solve_dual_qp_l(t(J), [(0, t(blocks[0][1]))], t(reg), t(b), 8, t(f_warm), 0, None, t(diag), None)
    assert (f.numpy() == 0).any() and (f.numpy() > 0).any()
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-9, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-9, rtol=0)


def test_policy_rollout_reference_matches_jax():
    """policy_rollout_lanes against JAX's (backend "xla"), R 3, T 2 ticks of 2
    steps, float64, from a nonzero policy output."""
    jtask = JaxSpotNavigate()
    jtask._planning_dtype = jnp.float64
    task = SpotNavigate(device="cpu", dtype=torch.float64)
    qp, qv, pout, cmds = policy_inputs(task.nv, 2, seed=3)
    ref = jax_policy_rollout_lanes(
        jtask.planning_model, jtask.policy, *(jnp.asarray(x) for x in (qp, qv, cmds, pout)),
        physics_substeps=2, iterations=8, backend="xla",
    )
    out = pr.policy_rollout_lanes(task.planning_model, task.policy, *(torch.tensor(x) for x in (qp, qv, cmds, pout)), 2, 8)
    assert out.states.shape == (R, 2, 51) and out.sensordata.shape == (R, 2, 48)
    for name in ("states", "sensordata", "final_policy_output"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-8, rtol=0, err_msg=name
        )


def test_policy_rollout_host_twin_matches_plain_version():
    """The policy kernel's body, compiled by g++ with the warp's 32 lanes
    played in one thread, against the plain version."""
    task = SpotNavigate(device="cpu", dtype=torch.float64)
    qp, qv, pout, cmds = policy_inputs(task.nv, 3, seed=4)
    args = (torch.tensor(qp.T.copy()), torch.tensor(qv.T.copy()), torch.tensor(pout.T.copy()),
            torch.tensor(cmds.transpose(1, 2, 0).copy()))
    ref = pr.policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8)
    twin = pr.fused_policy_rollout_host_twin(task.planning_model, task.policy, *args, 2, 8)
    for name, a, b in zip(("qpos", "qvel", "sensors", "pout"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)
    before = pr.fused_policy_rollout.launches
    out = pr.fused_policy_rollout(task.planning_model, task.policy, *args, 2, 8)
    assert pr.fused_policy_rollout.launches == before  # CPU tensors never launch the kernel
    assert torch.equal(out[0], ref[0])
    with pytest.raises(ValueError, match="cmds has shape"):
        pr.fused_policy_rollout(task.planning_model, task.policy, *args[:3], args[3][:, :24], 2, 8)


@pytest.mark.parametrize("B", [1, 33])
def test_policy_rollout_host_twin_batch_sizes(B):
    """The policy kernel's body against the plain version at one rollout and
    at 33, one more than a warp: 2 ticks of 2 steps, float64."""
    task = SpotNavigate(device="cpu", dtype=torch.float64)
    qp, qv, pout, cmds = policy_inputs(task.nv, 2, seed=13, B=B)
    args = (torch.tensor(qp.T.copy()), torch.tensor(qv.T.copy()), torch.tensor(pout.T.copy()),
            torch.tensor(cmds.transpose(1, 2, 0).copy()))
    ref = pr.policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8)
    twin = pr.fused_policy_rollout_host_twin(task.planning_model, task.policy, *args, 2, 8)
    for name, a, b in zip(("qpos", "qvel", "sensors", "pout"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)


def test_policy_pack_is_input_major():
    """The kernel's pack of the MLP (each layer's weights input-major, element
    (i, r) at i * out + r, then its biases) gives the nn.Module's layer
    outputs on a random input, float64."""
    from judo_tpu_torch.tasks.spot.policy import activate

    pol = SpotNavigate(device="cpu", dtype=torch.float64).policy
    _, pf, maxw = pr.pack_policy(pol, "cpu", torch.float64)
    assert maxw == max(pol.dims) == 512
    flat = pf.numpy()[len(sc.DEFAULT_JOINT_POS) :]
    x = torch.tensor(np.random.default_rng(14).standard_normal((pol.dims[0], 1)))
    h, o = x, 0
    for lin, act, ni, no in zip(pol.layers, pol.activations, pol.dims[:-1], pol.dims[1:]):
        W, b = flat[o : o + ni * no].reshape(ni, no), flat[o + ni * no : o + (ni + 1) * no]
        o += (ni + 1) * no
        ours = activate(act, torch.tensor(W.T) @ h + torch.tensor(b)[:, None])
        h = activate(act, lin.weight.double() @ h + lin.bias.double()[:, None])
        np.testing.assert_allclose(ours.numpy(), h.numpy(), atol=1e-12, rtol=0)
    assert o == flat.size
    np.testing.assert_allclose(h[:, 0].numpy(), pol(x.T)[0].numpy(), atol=1e-12, rtol=0)


def _step_inputs(scene, B=R):
    if scene == "leap":
        m = put_model(mujoco.MjModel.from_xml_string(leap_cube_xml()), dtype=np.float64, solver_iterations=8)
        rng = np.random.default_rng(9)
        qp = np.tile(QPOS_REST, (B, 1)).T.copy()
        qp[:3] += 5e-4 * rng.standard_normal((3, B))
        ctrl = QPOS_REST[7:][:, None] + 0.1 * rng.standard_normal((16, B))
        qv = 0.05 * rng.standard_normal((m.nv, B))
    elif scene == "cartpole":
        m = put_model(mujoco.MjModel.from_xml_string(CARTPOLE), dtype=np.float64)
        rng = np.random.default_rng(15)
        qp = np.stack([1.85 + 0.01 * rng.standard_normal(B), 2.9 + rng.standard_normal(B)])  # past the cart's limit
        qv, ctrl = rng.standard_normal((2, B)), rng.standard_normal((1, B))
    else:
        m = SpotNavigate(device="cpu", dtype=torch.float64).planning_model
        qp, qv, _, _ = policy_inputs(m.nv, 1, seed=10, B=B)
        qp, qv = qp.T.copy(), qv.T.copy()
        ctrl = np.tile(TARGETS[:, None], (1, B))
    f = np.abs(0.05 * np.random.default_rng(11).standard_normal((num_constraint_rows(m), B)))
    return m, [torch.tensor(x) for x in (qp, qv, ctrl, f)]


@pytest.mark.parametrize("scene", ["leap", "spot", "spot_b33", "cartpole"])
def test_physics_step_host_twin_matches_plain_version(scene):
    """The single-step kernel's body (cold probe), compiled by g++ with the
    warp's 32 lanes played in one thread, against step_l(cw_v=None): 3
    rollouts, 33 for spot_b33; cartpole's 2 constraint rows leave most lanes
    idle."""
    m, args = _step_inputs(scene.removesuffix("_b33"), 33 if scene.endswith("_b33") else R)
    ref = fr.physics_step_reference(m, *args, 8)
    plain = ls.step_l(m, *args, 8, cw_v=None)
    np.testing.assert_array_equal(ref[1].numpy(), plain.qvel.numpy())
    twin = fr.physics_step_host_twin(m, *args, 8)
    assert float(ref[3].abs().max()) > 1e-3
    for name, a, b in zip(("qpos", "qvel", "sensors", "efc"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)


@pytest.mark.cuda
def test_policy_kernel_matches_plain_version_on_gpu():
    """On the card: the fused policy rollout against its plain version, f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    task = SpotNavigate(device="cuda", dtype=torch.float64)
    qp, qv, pout, cmds = policy_inputs(task.nv, 2, seed=12)
    args = [torch.tensor(x, device="cuda") for x in (qp.T.copy(), qv.T.copy(), pout.T.copy(), cmds.transpose(1, 2, 0).copy())]
    ref = pr.policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8)
    out = pr.fused_policy_rollout(task.planning_model, task.policy, *args, 2, 8)
    for a, b in zip(ref, out):
        torch.testing.assert_close(b, a, atol=1e-8, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["leap", "spot"])
def test_step_kernel_matches_plain_version_on_gpu(scene):
    """On the card: the single-step kernel against step_l with a cold probe, f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    m, args = _step_inputs(scene)
    args = [x.cuda() for x in args]
    ref = fr.physics_step_reference(m, *args, 8)
    out = fr.physics_step(m, *args, 8)
    for a, b in zip(ref, out):
        torch.testing.assert_close(b, a, atol=1e-8, rtol=0)
