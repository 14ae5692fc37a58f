"""The narrowphase pair kinds, joint-equality rows and distance sensors of the
PyTorch port held against the JAX package, in the plain version and in the
CUDA step body built with g++ (the host twin).

Tolerances, float64: each pair kind's slots 1e-12 (plain and host twin, on
poses that reach every branch); equality rows and distance sensors on the fr3
planning model 1e-9; the host twin's rollout against the plain version on
cylinder_push and fr3, 1 and 33 rollouts, 1e-9.

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
from judo_tpu_torch import _build
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_collision as lc
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics import lane_step as ls
from judo_tpu_torch.physics.model import SENSOR_DISTANCE, num_constraint_rows, put_model
from judo_tpu_torch.tasks.cylinder_push import CYLINDER_PUSH_XML
from judo_tpu_torch.tasks.fr3_pick import QPOS_HOME as FR3_HOME

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
}


def _axis_frames(axis_z: np.ndarray, rng) -> np.ndarray:
    """(B, 3, 3) rotation matrices whose z column is ``axis_z`` (B, 3)."""
    z = axis_z / np.linalg.norm(axis_z, axis=1, keepdims=True)
    x = np.cross(z, rng.standard_normal(z.shape))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.stack([x, np.cross(z, x), z], axis=2)


def _poses(kind: str, B: int = 16):
    """Pair-stacked poses (P, 3, B), (P, 3, 3, B) and sizes (P, 3), one group
    of B per branch of the kind."""
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
    assert len(ours) == len(ref) == {"capsule_capsule": 1, "cylinder_cylinder": 2, "cylinder_box": 2}[kind]
    d0 = np.asarray(ref[0][0])
    assert (d0 < 0).any() and ((d0 > 0) & (d0 < 1e9)).any()  # penetrating and separated poses
    if kind == "cylinder_cylinder":
        assert (d0 == 1e10).any()  # poses with no radial contact
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
