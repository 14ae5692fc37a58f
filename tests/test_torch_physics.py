"""The lanes physics of the PyTorch port held against the JAX package on the
leap planning model, float64, 4 rollouts from perturbed contact states.

Tolerances: smooth dynamics 1e-10, narrowphase slots 1e-9 (random boxes, so
no separating-axis ties), the dual solve 1e-9, one full step 1e-8.
"""

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
from judo_tpu_torch.physics import lane_collision as lc
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics import lane_step as ls
from judo_tpu_torch.physics.model import put_model
from judo_tpu_torch.tasks.leap_cube import QPOS_REST

R = 4


@pytest.fixture(scope="module")
def leap():
    mj = mujoco.MjModel.from_xml_path(leap_cube_xml_path())
    jm = jax_put_model(mj, dtype=jnp.float64, solver_iterations=8)
    pm = put_model(mj, dtype=np.float64, solver_iterations=8)
    rng = np.random.default_rng(0)
    qp = np.tile(QPOS_REST, (R, 1))
    qp[:, :3] += 5e-4 * rng.standard_normal((R, 3))
    qp[:, 7:] += 0.05 * rng.standard_normal((R, mj.nu))
    qv = 0.1 * rng.standard_normal((R, mj.nv))
    ctrl = QPOS_REST[7:][:, None] + 0.1 * rng.standard_normal((mj.nu, R))
    return mj, jm, pm, qp.T.copy(), qv.T.copy(), ctrl


def test_smooth_dynamics_match_jax(leap):
    _, jm, pm, qp, qv, _ = leap

    @jax.jit
    def ref(q, v):
        kin = jle.kinematics_l(jm, q)
        com = jle.com_l(jm, kin)
        vel = jle.velocity_l(jm, com, v)
        M = jle.crb_mass_matrix_l(jm, com)
        blocks = jle.spd_inverse_blocks(jm, M)
        return (jnp.stack(kin.xpos), jnp.stack(kin.xquat), jnp.stack(kin.xmat), jnp.stack(kin.geom_xpos),
                jnp.stack(kin.geom_xmat), jnp.stack(kin.site_xpos), M, jle.rne_bias_l(jm, com, vel, v),
                [b for _, b in blocks])

    j = ref(jnp.asarray(qp), jnp.asarray(qv))
    q, v = torch.tensor(qp), torch.tensor(qv)
    kin = le.kinematics_l(pm, q)
    com = le.com_l(pm, kin)
    vel = le.velocity_l(pm, com, v)
    M = le.crb_mass_matrix_l(pm, com)
    blocks = le.spd_inverse_blocks(pm, M)
    ours = (kin.xpos, kin.xquat, kin.xmat, kin.geom_xpos, kin.geom_xmat, kin.site_xpos, M,
            le.rne_bias_l(pm, com, vel, v), [b for _, b in blocks])
    names = ("xpos", "xquat", "xmat", "geom_xpos", "geom_xmat", "site_xpos", "M", "bias")
    for name, a, b in zip(names, ours, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=0, err_msg=name)
    assert [s for s, _ in blocks] == [0, 6, 10, 14, 18]
    for a, b in zip(ours[-1], j[-1]):  # entries reach 2e5 (finger inertias ~1e-5): relative to the block
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-10 * np.abs(b).max(), rtol=0, err_msg="island inverse")
    np.testing.assert_allclose(
        le.bd_mat_vec(blocks, le.mat_vec_l(M, v)).numpy(), qv, atol=1e-10, err_msg="inverse times M"
    )


def _random_frames(rng, P, B):
    q = rng.standard_normal((P, 4, B))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    m = np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1),
        ],
        1,
    )
    return m  # (P, 3, 3, B)


@pytest.mark.parametrize("kind", ["box_box", "capsule_box"])
def test_narrowphase_matches_jax(kind):
    rng = np.random.default_rng(11 if kind == "box_box" else 12)
    P, B = 5, 64
    x1 = 0.03 * rng.standard_normal((P, 3, B))
    x2 = 0.03 * rng.standard_normal((P, 3, B))
    m1, m2 = _random_frames(rng, P, B), _random_frames(rng, P, B)
    s1 = rng.uniform(0.01, 0.03, (P, 3))
    s2 = rng.uniform(0.01, 0.03, (P, 3))
    jk = jlc._k_box_box if kind == "box_box" else jlc._k_capsule_box
    tk = lc._k_box_box if kind == "box_box" else lc._k_capsule_box
    cols = lambda s: tuple(jnp.asarray(s[:, k : k + 1]) for k in range(3))  # noqa: E731
    # op by op, not under jit: XLA's fusion rounds the clamped capsule
    # endpoint differently from the free one, which flips exact ties between
    # the two candidate points (the discrete branches of trouble spot D)
    ref = jk(jnp.asarray(x1), jnp.asarray(m1), cols(s1), jnp.asarray(x2), jnp.asarray(m2), cols(s2))
    ours = tk(torch.tensor(x1), torch.tensor(m1), torch.tensor(s1), torch.tensor(x2), torch.tensor(m2), torch.tensor(s2))
    assert len(ours) == len(ref) == (4 if kind == "box_box" else 2)
    d0 = ours[0][0].numpy()
    assert (d0 < 0).mean() > 0.2 and (d0 > 0).mean() > 0.2  # penetrating and separated cases
    for s, ((d, p, n), (jd, jp, jn)) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-9, rtol=0, err_msg=f"dist slot {s}")
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-9, rtol=0, err_msg=f"pos slot {s}")
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-9, rtol=0, err_msg=f"normal slot {s}")


def test_find_contacts_leap_matches_jax(leap):
    _, jm, pm, qp, _, _ = leap

    @jax.jit
    def ref(q):
        c = jlc.find_contacts_l(jm, jle.kinematics_l(jm, q))
        return c.dist, c.pos, c.normal

    jd, jp, jn = ref(jnp.asarray(qp))
    c = lc.find_contacts_l(pm, le.kinematics_l(pm, torch.tensor(qp)))
    assert c.ncon == 68 and (c.dist.numpy() < 0).any()
    np.testing.assert_allclose(c.dist.numpy(), np.asarray(jd), atol=1e-9, rtol=0)
    np.testing.assert_allclose(c.pos.numpy(), np.asarray(jp), atol=1e-9, rtol=0)
    np.testing.assert_allclose(c.normal.numpy(), np.asarray(jn), atol=1e-9, rtol=0)
    jc = jlc.find_contacts_l(jm, jle.kinematics_l(jm, jnp.asarray(qp)))
    assert c.body1 == jc.body1 and c.body2 == jc.body2
    np.testing.assert_allclose(c.friction, jc.friction)
    np.testing.assert_allclose(c.solimp, jc.solimp)


def test_dual_solve_matches_jax():
    """Identical J, M^-1 blocks, reg, b, diag, mu, f_warm and probe in; f and
    the carried probe out."""
    rng = np.random.default_rng(5)
    nv, B, ns, nc = 10, 8, 4, 6
    nefc = ns + 3 * nc
    J = rng.standard_normal((nefc, nv, B))
    blocks = []
    for s, e in ((0, 6), (6, 10)):
        a = rng.standard_normal((e - s, e - s, B))
        spd = np.einsum("ikb,jkb->ijb", a, a) + (e - s) * np.eye(e - s)[:, :, None]
        blocks.append((s, np.linalg.inv(spd.transpose(2, 0, 1)).transpose(1, 2, 0)))
    reg = rng.uniform(0.01, 0.1, (nefc, B))
    b = rng.standard_normal((nefc, B))
    diag = rng.uniform(0.5, 2.0, (nefc, B))
    mus = [float(v) for v in rng.uniform(0.2, 1.0, nc)]
    f_warm = np.abs(rng.standard_normal((nefc, B)))
    cw_v = rng.uniform(0.1, 1.0, (nefc, B))
    jf, jv = jax.jit(
        lambda J_, r_, b_, d_, fw, v_: jls.solve_dual_qp_l(
            J_, [(s, jnp.asarray(m)) for s, m in blocks], r_, b_, 8, fw, "cw", ncon_start=ns, mus=mus, diag=d_, cw_v=v_
        )
    )(*(jnp.asarray(x) for x in (J, reg, b, diag, f_warm, cw_v)))
    t = torch.tensor
    f, v = ls.solve_dual_qp_l(
        t(J), [(s, t(m)) for s, m in blocks], t(reg), t(b), 8, t(f_warm), ncon_start=ns, mus=mus, diag=t(diag), cw_v=t(cw_v)
    )
    assert np.abs(np.asarray(jf)).max() > 1e-2
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-9, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-9, rtol=0)


def test_step_matches_jax(leap):
    _, jm, pm, qp, qv, ctrl = leap
    nefc = 236
    rng = np.random.default_rng(6)
    f_warm = np.abs(0.01 * rng.standard_normal((nefc, R)))
    cw_v = rng.uniform(0.5, 1.0, (nefc, R))
    j = jax.jit(lambda a, b, c, f, v: jls.step_l(jm, a, b, c, f, solver_iterations=8, cw_v=v))(
        *(jnp.asarray(x) for x in (qp, qv, ctrl, f_warm, cw_v))
    )
    t = torch.tensor
    ours = ls.step_l(pm, t(qp), t(qv), t(ctrl), t(f_warm), 8, cw_v=t(cw_v))
    assert np.abs(np.asarray(j.efc_force)).max() > 1e-3  # contacts are active
    for name in ("qpos", "qvel", "sensordata", "efc_force", "cw_v"):
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), np.asarray(getattr(j, name)), atol=1e-8, rtol=0, err_msg=name
        )
