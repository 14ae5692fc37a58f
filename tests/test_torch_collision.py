"""The narrowphase pair kinds, joint-equality rows and distance sensors of the
PyTorch port held against the JAX package, in the plain version and in the
CUDA step body built with g++ (the host twin).

Tolerances, float64: each pair kind's slots 1e-12 (plain and host twin, on
poses that reach every branch); equality rows and distance sensors on the fr3
planning model 1e-9; the host twin's rollout against the plain version on
cylinder_push and fr3, 1 and 33 rollouts, 1e-9. On the Spot object scenes
(spot_box_push, and spot_tire_upright with its tire lying flat): the contact
slots against the JAX package's at 1e-12 and the constraint rows at 1e-9; the
policy rollout's host twin against its plain version, 1 and 33 rollouts, in
both scratch layouts (the whole scratch in one buffer, and J in a slab of its
own), 1e-9.

The JAX lanes distance sensor (``lane_step._distance_sensor_l``) calls the
pair-stacked narrowphase kernels on unstacked (3, B) frames, which the box-box
kernel cannot index (IndexError at ``lane_collision.py:372``), so the JAX
lanes path cannot evaluate fr3's five box-box distance sensors.
``stacked_distance_sensor_l`` is that function with the pair axis of length 1
the kernels expect, and nothing else changed; the reference runs with it
patched in.
"""

import ctypes
from unittest import mock

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.models.fr3 import build_fr3_pick_xml
from judo_tpu.physics import lane_collision as jlc
from judo_tpu.physics import lane_engine as jle
from judo_tpu.physics import lane_step as jls
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.tasks.spot.spot_base import _spot_planner_pairs as jax_spot_pairs
from judo_tpu_torch import _build
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_collision as lc
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics import lane_step as ls
from judo_tpu_torch.models.spot import spot_xml
from judo_tpu_torch.physics import policy_rollout as pr
from judo_tpu_torch.physics.model import SENSOR_DISTANCE, num_constraint_rows, put_model
from judo_tpu_torch.tasks import get_registered_tasks
from judo_tpu_torch.tasks.cylinder_push import CYLINDER_PUSH_XML
from judo_tpu_torch.tasks.fr3_pick import QPOS_HOME as FR3_HOME
from judo_tpu_torch.tasks.spot import spot_constants as sc

from .test_torch_physics import _random_frames


def stacked_distance_sensor_l(m, kin, body1, body2, cutoff):
    """judo_tpu's lane_step._distance_sensor_l, calling its kernels with a
    pair axis of length 1."""
    size = np.asarray(m.geom_size, np.float64)
    out = jnp.full(kin.xpos[0].shape[-1], float(cutoff), kin.xpos[0].dtype)
    for g1 in range(m.ngeom):
        if m.geom_bodyid[g1] != body1 and m.geom_bodyid[g1] != body2:
            continue
        for g2 in range(m.ngeom):
            if m.geom_bodyid[g1] == body1 and m.geom_bodyid[g2] != body2:
                continue
            if m.geom_bodyid[g1] == body2 and m.geom_bodyid[g2] != body1:
                continue
            if m.geom_bodyid[g1] == m.geom_bodyid[g2]:
                continue
            a, b = (g1, g2) if m.geom_type[g1] <= m.geom_type[g2] else (g2, g1)
            kernel = jlc._L_KERNELS.get((m.geom_type[a], m.geom_type[b]))
            if a != g1 or kernel is None:
                continue
            cols = lambda g: tuple(jnp.full((1, 1), float(size[g, k]), out.dtype) for k in range(3))  # noqa: E731
            for d, _, _ in kernel(kin.geom_xpos[a][None], kin.geom_xmat[a][None], cols(a), kin.geom_xpos[b][None],
                                  kin.geom_xmat[b][None], cols(b)):
                out = jnp.minimum(out, d[0])
    return out


def patched_jax_distance_sensor():
    """The JAX lanes step with ``stacked_distance_sensor_l`` in place."""
    return mock.patch.object(jls, "_distance_sensor_l", stacked_distance_sensor_l)


KINDS = {
    "capsule_capsule": (jlc._k_capsule_capsule, lc._k_capsule_capsule, 5),
    "cylinder_cylinder": (jlc._k_cylinder_cylinder, lc._k_cylinder_cylinder, 6),
    "cylinder_box": (jlc._k_cylinder_box, lc._k_cylinder_box, 7),
    "sphere_box": (jlc._k_sphere_box, lc._k_sphere_box, 8),
    "plane_cylinder": (jlc._k_plane_cylinder, lc._k_plane_cylinder, 9),
    "sphere_cylinder": (jlc._k_sphere_cylinder, lc._k_sphere_cylinder, 10),
    "capsule_cylinder": (jlc._k_capsule_cylinder, lc._k_capsule_cylinder, 11),
}
SLOTS = {"capsule_capsule": 1, "cylinder_cylinder": 2, "cylinder_box": 2, "sphere_box": 1, "plane_cylinder": 2,
         "sphere_cylinder": 1, "capsule_cylinder": 1}
# Sizes of the Spot scenes' geoms: the foot sphere, the leg capsule, the box
# and the tire cylinder (judo_tpu_torch/models/spot.py).
FOOT, LEG, BOX, TIRE = (0.036, 0.0, 0.0), (0.05, 0.165, 0.0), (0.254, 0.254, 0.254), (0.33, 0.17, 0.0)


def _axis_frames(axis_z: np.ndarray, rng) -> np.ndarray:
    """(B, 3, 3) rotation matrices whose z column is ``axis_z`` (B, 3)."""
    z = axis_z / np.linalg.norm(axis_z, axis=1, keepdims=True)
    x = np.cross(z, rng.standard_normal(z.shape))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.stack([x, np.cross(z, x), z], axis=2)


def _quat_mat(q: np.ndarray) -> np.ndarray:
    """(B, 3, 3) rotation matrices of (B, 4) wxyz quaternions."""
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1),
    ], 1)


def _quat_mul(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = u.T
    w2, x2, y2, z2 = v.T
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], 1)


def flat_tire_frames(rng, B: int) -> np.ndarray:
    """The tire geom's frames in spot_tire_upright's reset: a random yaw of the
    body quat (1, +-1, 0, 0)/sqrt(2), composed with the geom's quat="1 1 0 0",
    which puts the cylinder's axis along +-z."""
    yaw = rng.uniform(0, 2 * np.pi, B)
    sign = np.where(np.arange(B) % 2 == 0, 1.0, -1.0)
    body = _quat_mul(np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1),
                     np.stack([np.ones(B), sign, 0 * yaw, 0 * yaw], 1) / np.sqrt(2))
    return _quat_mat(_quat_mul(body, np.tile([1.0, 1.0, 0.0, 0.0], (B, 1)) / np.sqrt(2)))


def _spot_object_poses(kind: str, B: int):
    """The four pair kinds of the Spot object scenes, at those scenes' sizes."""
    rng = np.random.default_rng({"sphere_box": 24, "plane_cylinder": 25, "sphere_cylinder": 26,
                                 "capsule_cylinder": 27}[kind])
    free = lambda: _random_frames(rng, 1, B)[0].transpose(2, 0, 1)  # noqa: E731
    groups = []
    if kind == "sphere_box":
        box = free()
        for scale in (0.9, 1.3):  # centres inside the box, then around it
            local = scale * np.array(BOX) * rng.uniform(-1, 1, (B, 3))
            local[::4, 0] = np.sign(local[::4, 0]) * BOX[0] * 0.99  # near a face
            groups.append((np.einsum("bij,bj->bi", box, local), free(), np.zeros((B, 3)), box))
        s1, s2 = FOOT, BOX
    elif kind == "plane_cylinder":
        ground = np.tile(np.eye(3), (B, 1, 1))
        flat = flat_tire_frames(rng, B)
        h = TIRE[1] + rng.uniform(-0.02, 0.02, B)
        groups.append((np.zeros((B, 3)), ground, np.c_[rng.uniform(-2, 2, (B, 2)), h], flat))  # lying flat
        exact = np.tile(np.diag([1.0, -1.0, -1.0]), (B, 1, 1))
        groups.append((np.zeros((B, 3)), ground, np.c_[np.zeros((B, 2)), h], exact))  # axis exactly along -z
        plane = free()
        center = np.einsum("bij,bj->bi", plane, np.c_[rng.uniform(-1, 1, (B, 2)), rng.uniform(-0.1, 0.5, B)])
        groups.append((rng.uniform(-0.1, 0.1, (B, 3)), plane, center, free()))  # tilted
        s1, s2 = (10.0, 10.0, 0.01), TIRE
    else:
        s1 = FOOT if kind == "sphere_cylinder" else LEG
        for reach in (0.3, 0.6):
            groups.append((reach * rng.uniform(-1, 1, (B, 3)), free(), np.zeros((B, 3)), free()))
        s2 = TIRE
    x1, m1, x2, m2 = (np.stack([g[k] for g in groups]) for k in range(4))
    P = len(groups)
    return (x1.transpose(0, 2, 1), m1.transpose(0, 2, 3, 1), np.tile(s1, (P, 1)), x2.transpose(0, 2, 1),
            m2.transpose(0, 2, 3, 1), np.tile(s2, (P, 1)))


def _poses(kind: str, B: int = 16):
    """Pair-stacked poses (P, 3, B), (P, 3, 3, B) and sizes (P, 3), one group
    of B per branch of the kind."""
    if kind not in ("capsule_capsule", "cylinder_cylinder", "cylinder_box"):
        return _spot_object_poses(kind, B)
    rng = np.random.default_rng({"capsule_capsule": 21, "cylinder_cylinder": 22, "cylinder_box": 23}[kind])
    x1, x2, m1, m2 = [], [], [], []

    def group(p1, p2, f1, f2):
        x1.append(p1.T), x2.append(p2.T), m1.append(f1.transpose(1, 2, 0)), m2.append(f2.transpose(1, 2, 0))

    free = lambda: _random_frames(rng, 1, B)[0].transpose(2, 0, 1)  # noqa: E731
    near = lambda s: s * rng.standard_normal((B, 3))  # noqa: E731
    # skew, both overlapping and separated
    group(near(0.04), near(0.04), free(), free())
    if kind == "capsule_capsule":
        f = free()
        group(near(0.03), near(0.03), f, f)  # parallel segments: the denominator branch
        a = free()
        group(np.zeros((B, 3)), np.zeros((B, 3)), a, np.stack([a[:, :, 2], a[:, :, 0], a[:, :, 1]], axis=2))  # crossing
    elif kind == "cylinder_cylinder":
        f = free()
        tilt = _axis_frames(f[:, :, 2] + 0.05 * rng.standard_normal((B, 3)), rng)
        side = 0.05 * f[:, :, 0]
        group(np.zeros((B, 3)), side + 0.01 * f[:, :, 2], f, tilt)  # near-parallel, heights overlap
        group(np.zeros((B, 3)), side + 0.2 * f[:, :, 2], f, tilt)  # near-parallel, heights apart
        group(np.zeros((B, 3)), 0.01 * f[:, :, 2], f, f)  # coaxial: no radial direction
    else:
        b = free()
        p2 = near(0.01)
        group(p2 + 0.035 * b[:, :, 2] + near(0.003), p2, _axis_frames(b[:, :, 0], rng), b)  # axis along a face
    P = len(x1)
    s1 = np.tile(rng.uniform(0.01, 0.03, (1, 3)), (P, 1))
    s2 = np.tile(rng.uniform(0.01, 0.03, (1, 3)), (P, 1))
    return np.stack(x1), np.stack(m1), s1, np.stack(x2), np.stack(m2), s2


def _jax_slots(kind, x1, m1, s1, x2, m2, s2):
    cols = lambda s: tuple(jnp.asarray(s[:, k : k + 1]) for k in range(3))  # noqa: E731
    return KINDS[kind][0](jnp.asarray(x1), jnp.asarray(m1), cols(s1), jnp.asarray(x2), jnp.asarray(m2), cols(s2))


def _host_twin_slots(kind, x1, m1, s1, x2, m2, s2, nslot):
    """The step body's scalar narrowphase (g++ build), pair by pair."""
    lib = _build.load("host")
    P, _, B = x1.shape
    d, pos, nrm = np.zeros((nslot, P, B)), np.zeros((nslot, P, 3, B)), np.zeros((nslot, P, 3, B))
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    for p in range(P):
        for b in range(B):
            args = [np.ascontiguousarray(a) for a in (x1[p, :, b], m1[p, :, :, b], s1[p], x2[p, :, b], m2[p, :, :, b], s2[p])]
            od, op, on = np.zeros(4), np.zeros(12), np.zeros(12)
            assert lib.jt_pair_contacts_f64(KINDS[kind][2], *map(ptr, args), ptr(od), ptr(op), ptr(on)) == 0
            d[:, p, b], pos[:, p, :, b], nrm[:, p, :, b] = od[:nslot], op.reshape(4, 3)[:nslot], on.reshape(4, 3)[:nslot]
    return d, pos, nrm


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pair_kind_matches_jax(kind):
    """Plain version and host twin against the JAX kernel, op by op (not under
    jit, whose fusion can flip exact ties), on every branch of the kind."""
    args = _poses(kind)
    ref = _jax_slots(kind, *args)
    ours = KINDS[kind][1](*(torch.tensor(a) for a in args))
    twin = _host_twin_slots(kind, *args, len(ref))
    assert len(ours) == len(ref) == SLOTS[kind]
    d0 = np.asarray(ref[0][0])
    assert (d0 < 0).any() and ((d0 > 0) & (d0 < 1e9)).any()  # penetrating and separated poses
    if kind == "cylinder_cylinder":
        assert (d0 == 1e10).any()  # poses with no radial contact
    x1, m1, _, x2, m2, s2 = args
    if kind == "sphere_box":  # centres inside the box and outside it
        local = np.abs(np.einsum("pkjb,pkb->pjb", m2, x1 - x2))
        inside = (local < s2[:, :, None]).all(axis=1)
        assert inside.any() and (~inside).any()
    if kind == "plane_cylinder":  # the rim direction from the normal, and from the x column where the axis is along it
        n, axis = m1[:, :, 2], m2[:, :, 2]
        proj = np.linalg.norm(axis * (axis * n).sum(1, keepdims=True) - n, axis=1)
        assert (proj <= 1e-8).sum() >= 32 and (proj > 1e-8).any()
    for s, ((d, p, n), (jd, jp, jn)) in enumerate(zip(ours, ref)):
        for name, a, b, t in (("dist", d, jd, twin[0][s]), ("pos", p, jp, twin[1][s]), ("normal", n, jn, twin[2][s])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0, err_msg=f"plain {name} slot {s}")
            np.testing.assert_allclose(t, np.asarray(b), atol=1e-12, rtol=0, err_msg=f"host twin {name} slot {s}")


def test_unknown_pair_kind_raises():
    """An unported code is never computed as another pair: the host twin
    reports it, and a rollout of a model carrying it raises."""
    lib = _build.load("host")
    z = np.zeros(12)
    p = z.ctypes.data_as(ctypes.c_void_p)
    assert lib.jt_pair_contacts_f64(99, *([p] * 9)) == -1
    assert b"unknown pair kind" in lib.jt_error_string(-1)
    m = put_model(mujoco.MjModel.from_xml_string(CYLINDER_PUSH_XML), dtype=np.float64)
    packed = fr.pack_model(m)
    lay = {"mi": packed["mi"].copy(), "mf": packed["mf"], "counts": packed["counts"]}
    first_pair = next(i for i in range(len(lay["mi"])) if lay["mi"][i] == fr.PAIR_KINDS[(5, 6)])
    lay["mi"][first_pair] = 99
    m._packed["packed"] = lay
    args = (torch.tensor([[0.0], [0.0], [2.0], [0.0]], dtype=torch.float64), torch.zeros(4, 1, dtype=torch.float64),
            torch.zeros(1, 2, 1, dtype=torch.float64), torch.zeros(num_constraint_rows(m), 1, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="unknown pair kind"):
        fr.fused_rollout_host_twin(m, *args)


@pytest.fixture(scope="module")
def fr3():
    mj = mujoco.MjModel.from_xml_string(build_fr3_pick_xml())
    rng = np.random.default_rng(31)
    R = 4
    qp = np.tile(FR3_HOME, (R, 1))
    qp[:, 7:14] += 0.1 * rng.standard_normal((R, 7))
    qp[:, 14] += 0.01 * rng.standard_normal(R)  # fingers apart from the coupling
    qp[:, :3] += 0.02 * rng.standard_normal((R, 3))
    qv = 0.2 * rng.standard_normal((R, mj.nv))
    return mj, jax_put_model(mj, dtype=jnp.float64), put_model(mj, dtype=np.float64), qp.T.copy(), qv.T.copy()


def test_fr3_equality_rows_and_distance_sensors_match_jax(fr3):
    mj, jm, pm, qp, qv = fr3
    assert pm.neq == 1 and [pm.sensor_type[i] for i in range(5)] == [SENSOR_DISTANCE] * 5
    jkin = jle.kinematics_l(jm, jnp.asarray(qp))
    jrows = jls.assemble_constraints_l(jm, jle.com_l(jm, jkin), jlc.find_contacts_l(jm, jkin), jnp.asarray(qp),
                                       jnp.asarray(qv))
    with pytest.raises(IndexError):  # the JAX lanes distance sensor as it stands (module docstring)
        jls.evaluate_sensors_l(jm, jkin, jnp.asarray(qp), jnp.asarray(qv))
    with patched_jax_distance_sensor():
        jsens = jls.evaluate_sensors_l(jm, jkin, jnp.asarray(qp), jnp.asarray(qv))
    q, v = torch.tensor(qp), torch.tensor(qv)
    kin = le.kinematics_l(pm, q)
    rows = ls.assemble_constraints_l(pm, le.com_l(pm, kin), lc.find_contacts_l(pm, kin), q, v)
    sens = ls.evaluate_sensors_l(pm, kin, q, v)
    assert rows.J.shape[0] == num_constraint_rows(pm) == 2 + 18 + 4 * 124
    assert np.abs(rows.aref[:2].numpy()).min() > 1e-3  # the fingers violate their coupling
    for name in ("J", "aref", "reg", "active", "diag"):
        np.testing.assert_allclose(getattr(rows, name).numpy(), np.asarray(getattr(jrows, name)), atol=1e-9, rtol=0,
                                   err_msg=name)
    dist = sens[:5].numpy()
    assert (dist < 1.0).all() and (dist > 0).any() and (dist < 0).any()  # below the cutoff, touching or not
    np.testing.assert_allclose(sens.numpy(), np.asarray(jsens), atol=1e-9, rtol=0)


def _scene_batch(scene: str, B: int, T: int):
    rng = np.random.default_rng(41 + B)
    if scene == "cylinder_push":
        m = put_model(mujoco.MjModel.from_xml_string(CYLINDER_PUSH_XML), dtype=np.float64, solver_iterations=8)
        qp = np.tile([0.3, 0.0, 0.72, 0.0], (B, 1)) + 0.05 * rng.standard_normal((B, 4))  # the cylinders touch
        qv = rng.standard_normal((B, 4))
        ct = rng.standard_normal((B, T, 2))
    else:
        m = put_model(mujoco.MjModel.from_xml_string(build_fr3_pick_xml()), dtype=np.float64, solver_iterations=8)
        qp = np.tile(FR3_HOME, (B, 1))
        qp[:, 7:14] += 0.1 * rng.standard_normal((B, 7))
        qv = 0.2 * rng.standard_normal((B, m.nv))
        ct = np.concatenate([FR3_HOME[7:14], [0.04]])[None, None] + 0.05 * rng.standard_normal((B, T, 8))
    return m, qp, qv, ct


@pytest.mark.parametrize("scene", ["cylinder_push", "fr3"])
@pytest.mark.parametrize("B", [1, 33])
def test_host_twin_matches_plain_version(scene, B):
    """The CUDA step body (g++ build) against the plain version: 3 steps,
    float64, warm-start forces carried in."""
    m, qp, qv, ct = _scene_batch(scene, B, 3)
    nefc = num_constraint_rows(m)
    f0 = torch.tensor(np.abs(0.05 * np.random.default_rng(5).standard_normal((nefc, B))))
    args = (torch.tensor(qp.T.copy()), torch.tensor(qv.T.copy()), torch.tensor(ct.transpose(1, 2, 0).copy()), f0)
    ref = fr.rollout_lanes_reference(m, *args, 1, 8)
    twin = fr.fused_rollout_host_twin(m, *args, 1, 8)
    assert np.abs(ref[3].numpy()).max() > 1e-3  # constraints carry force
    for name, a, b in zip(("qpos", "qvel", "sensors", "efc0"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)


# The Spot object scenes: the pair kinds in first-seen order with their pair
# counts, and the constraint rows (38 joint-limit rows, 4 facets per slot).
OBJECT_SCENES = {
    "spot_box_push": ([((0, 6), 7), ((0, 3), 16), ((0, 2), 5), ((6, 6), 6), ((3, 6), 16), ((2, 6), 5)], 542),
    "spot_tire_upright": ([((0, 6), 6), ((0, 3), 16), ((0, 2), 5), ((0, 5), 1), ((5, 6), 6), ((3, 5), 16),
                           ((2, 5), 5)], 422),
}


def _object_states(scene: str, B: int, seed: int):
    """(qpos (nq, B), qvel (nv, B)): the robot standing with its feet 3 cm in
    the ground and its arm stowed, the object against its front feet: the box
    upright, the tire flat (the degenerate plane-cylinder pose)."""
    rng = np.random.default_rng(seed)
    robot = np.r_[0.0, 0.0, sc.STANDING_HEIGHT - 0.03, 1, 0, 0, 0, sc.LEGS_STANDING_POS, sc.ARM_STOWED_POS]
    qp = np.tile(robot, (B, 1))
    qp[:, 7:] += 0.05 * rng.standard_normal((B, 19))
    if scene == "spot_box_push":
        obj = np.tile([0.55, 0.0, sc.BOX_HALF_LENGTH - 0.01, 1, 0, 0, 0], (B, 1))
        obj[:, :2] += 0.03 * rng.standard_normal((B, 2))
        obj[:, 3:] += 0.05 * rng.standard_normal((B, 4))
        obj[:, 3:] /= np.linalg.norm(obj[:, 3:], axis=1, keepdims=True)
    else:
        yaw = rng.uniform(0, 2 * np.pi, B)
        sign = np.where(np.arange(B) % 2 == 0, 1.0, -1.0)
        flat = _quat_mul(np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1),
                         np.stack([np.ones(B), sign, 0 * yaw, 0 * yaw], 1) / np.sqrt(2))
        obj = np.c_[0.62 + 0.03 * rng.standard_normal(B), 0.03 * rng.standard_normal(B),
                    np.full(B, sc.TIRE_HALF_WIDTH - 0.01), flat]
    qp = np.c_[qp, obj]
    qv = 0.05 * rng.standard_normal((B, qp.shape[1] - 2))  # two free joints: 7 qpos, 6 dofs each
    return qp.T.copy(), qv.T.copy()


@pytest.mark.parametrize("scene", sorted(OBJECT_SCENES))
def test_object_scene_contacts_match_jax(scene):
    """The scene's planning model (the Spot pair filter applied) lowers to the
    JAX package's pair kinds in its order; every contact slot and the
    constraint rows agree, with the object touching the robot's feet and
    the ground."""
    mj = mujoco.MjModel.from_xml_string(spot_xml(scene))
    from judo_tpu_torch.tasks.spot.spot_base import _spot_planner_pairs

    pm = put_model(mj, dtype=np.float64, solver_iterations=8, collision_pair_filter=_spot_planner_pairs)
    jm = jax_put_model(mj, dtype=jnp.float64, solver_iterations=8, collision_pair_filter=jax_spot_pairs)
    groups, nefc = OBJECT_SCENES[scene]
    assert [(sig, len(p)) for sig, p in lc.pair_groups(pm)] == groups
    assert num_constraint_rows(pm) == nefc and (pm.nq, pm.nv) == (33, 31)
    qp, qv = _object_states(scene, 4, seed=61)
    jkin = jle.kinematics_l(jm, jnp.asarray(qp))
    jcon = jlc.find_contacts_l(jm, jkin)
    jrows = jls.assemble_constraints_l(jm, jle.com_l(jm, jkin), jcon, jnp.asarray(qp), jnp.asarray(qv))
    q, v = torch.tensor(qp), torch.tensor(qv)
    kin = le.kinematics_l(pm, q)
    con = lc.find_contacts_l(pm, kin)
    rows = ls.assemble_constraints_l(pm, le.com_l(pm, kin), con, q, v)
    for name in ("dist", "pos", "normal"):
        np.testing.assert_allclose(getattr(con, name).numpy(), np.asarray(getattr(jcon, name)), atol=1e-12, rtol=0,
                                   err_msg=name)
    assert con.body1 == tuple(jcon.body1) and con.body2 == tuple(jcon.body2)
    obj = pm.nbody - 1  # the object's body comes last
    touching = (con.dist.numpy() < 0).any(axis=1)
    assert touching[[b1 == obj or b2 == obj for b1, b2 in zip(con.body1, con.body2)]].sum() >= 2
    for name in ("J", "aref", "reg", "active", "diag"):
        np.testing.assert_allclose(getattr(rows, name).numpy(), np.asarray(getattr(jrows, name)), atol=1e-9, rtol=0,
                                   err_msg=name)


_OBJECT_PLAIN: dict = {}


def _object_rollout_inputs(scene: str, B: int):
    """The task, the policy rollout's inputs on the scene (2 ticks), and the
    plain version's outputs on them (computed once per scene and B)."""
    task = get_registered_tasks()[scene][0](device="cpu", dtype=torch.float64)
    qp, qv = _object_states(scene, B, seed=71 + B)
    rng = np.random.default_rng(72 + B)
    cmds = np.zeros((2, 25, B))
    cmds[:, :3] = 0.4 * rng.standard_normal((2, 3, B))
    cmds[:, 3:10] = sc.ARM_STOWED_POS[None, :, None]
    cmds[:, 24] = sc.STANDING_HEIGHT_CMD
    cmds[:, 13:16, 0] = 0.3  # the first rollout overrides its front-right leg
    args = [torch.tensor(x) for x in (qp, qv, 0.3 * rng.standard_normal((12, B)), cmds)]
    if (scene, B) not in _OBJECT_PLAIN:
        _OBJECT_PLAIN[scene, B] = pr.policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8)
    return task, args, _OBJECT_PLAIN[scene, B]


@pytest.mark.parametrize("layout", ["shared", "global_j"])
@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("scene", sorted(OBJECT_SCENES))
def test_policy_host_twin_matches_plain_on_object_scenes(scene, B, layout):
    """K2's body (g++ build) on the object scenes, whose observation reads the
    robot's joints ahead of the object's free joint, in both scratch
    layouts: 2 ticks of 2 steps, float64."""
    task, args, ref = _object_rollout_inputs(scene, B)
    twin = pr.fused_policy_rollout_host_twin(task.planning_model, task.policy, *args, 2, 8, layout=layout)
    assert float(ref[0][:, 26:29].std()) > 0  # the object moves
    for name, a, b in zip(("qpos", "qvel", "sensors", "pout"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)


@pytest.mark.parametrize("scene", sorted(OBJECT_SCENES))
def test_object_scene_scratch_layouts(scene):
    """Shared-memory bytes per rollout of K2 on the object scenes, from the
    host twin's sizes: the J slab takes nefc x (nv | 1) elements out of the
    shared scratch. In float64 the tire scenes fit the card's 227 KB opt-in
    limit whole and spot_box_push only with J in global memory."""
    task = get_registered_tasks()[scene][0](device="cpu", dtype=torch.float64)
    m, lib = task.planning_model, _build.load("host")
    sizes = fr._sizes(m, 1, 1, 1, None)
    maxw = max(task.policy.dims)
    whole = fr.scratch_elems(lib, sizes, fr.SHARED, maxw) * 8
    rest = fr.scratch_elems(lib, sizes, fr.GLOBAL_J, maxw) * 8
    assert whole - rest == 8 * num_constraint_rows(m) * (m.nv | 1)
    limit = 227 * 1024
    want = fr.SHARED if scene != "spot_box_push" else fr.GLOBAL_J
    assert fr.choose_layout(lib, sizes, 8, "fused_policy_rollout", maxw, limit) == (want, whole if want == fr.SHARED
                                                                                     else rest)
    assert fr.choose_layout(lib, sizes, 4, "fused_policy_rollout", maxw, limit) == (fr.SHARED, whole // 2)
