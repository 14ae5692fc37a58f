"""The lanes step's sphere-sphere and sphere-capsule pairs, springs on ball and
free joints and actuator force limits on them, in the PyTorch port, against the
JAX package, in the plain version and in the CUDA step body built with g++
(the host twin).

- The two pair kinds on seeded random frames (penetrating, separated, the
  capsule's ends and middle, coincident centres): plain and host twin against
  the JAX kernels, 1e-12 in float64.
- ``passive_force_l`` and ``actuation_l`` on the check scene
  (``judo_tpu_torch/models/check_scene.py``: a free sphere and a ball-joint
  pendulum, both with springs and force limits, and a slide-joint pusher)
  against the JAX functions, 1e-12.
- Eight steps of ``rollout_lanes`` on the scene against the JAX
  ``rollout_lanes(backend="xla")``: 1e-9 with the bodies apart, 1e-5 in
  contact (the tolerances of tests/test_physics/test_lanes.py); the host twin
  of the fused rollout against the plain version, 1e-9.
- ``lane_supported`` takes the scene and still refuses what the JAX lanes
  step does not model; the committed snapshot equals a fresh export.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.physics import lane_collision as jlc
from judo_tpu.physics import lane_engine as jle
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.pallas_step import rollout_lanes as jax_rollout_lanes
from judo_tpu_torch import _build
from judo_tpu_torch.models import check_scene
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_collision as lc
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics.model import lane_supported, num_constraint_rows, put_model

from .test_torch_physics import _random_frames

KINDS = {"sphere_sphere": (jlc._k_sphere_sphere, lc._k_sphere_sphere, 12),
         "sphere_capsule": (jlc._k_sphere_capsule, lc._k_sphere_capsule, 13)}
B = 16


def _poses(kind: str):
    """Pair-stacked (P, 3, B) centres, (P, 3, 3, B) frames and (P, 3) sizes:
    one group near contact, one far, and for sphere-sphere one of coincident
    centres; for sphere-capsule one group per part of the segment."""
    rng = np.random.default_rng({"sphere_sphere": 31, "sphere_capsule": 32}[kind])
    x1, x2, m1, m2 = [], [], [], []
    frames = lambda: _random_frames(rng, 1, B)[0]  # noqa: E731 — (3, 3, B)
    s1, s2 = np.array([0.04, 0.0, 0.0]), np.array([0.03, 0.05, 0.0])
    if kind == "sphere_sphere":
        for scale in (0.05, 0.3):  # overlapping and apart
            x1.append(scale * rng.standard_normal((3, B)))
            x2.append(scale * rng.standard_normal((3, B)))
        c = rng.standard_normal((3, B))
        x1.append(c), x2.append(c.copy())  # coincident: the +z fallback
        m1 = [frames() for _ in x1]
        m2 = [frames() for _ in x1]
    else:
        for along in (-2.0, 0.0, 2.0):  # beyond one end, beside the middle, beyond the other
            f = frames()
            axis = f[:, 2]
            x2.append(0.1 * rng.standard_normal((3, B)))
            x1.append(x2[-1] + along * s2[1] * axis + 0.05 * rng.standard_normal((3, B)))
            m1.append(frames()), m2.append(f)
    P = len(x1)
    return np.stack(x1), np.stack(m1), np.tile(s1, (P, 1)), np.stack(x2), np.stack(m2), np.tile(s2, (P, 1))


def _host_twin_slots(code: int, x1, m1, s1, x2, m2, s2):
    """The step body's narrowphase (g++ build), pair by pair: (1, P, B), (1, P, 3, B) x 2."""
    lib = _build.load("host")
    P = x1.shape[0]
    d, pos, nrm = np.zeros((1, P, B)), np.zeros((1, P, 3, B)), np.zeros((1, P, 3, B))
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    for p in range(P):
        for b in range(B):
            args = [np.ascontiguousarray(a) for a in (x1[p, :, b], m1[p, :, :, b], s1[p], x2[p, :, b],
                                                      m2[p, :, :, b], s2[p])]
            od, op, on = np.zeros(4), np.zeros(12), np.zeros(12)
            assert lib.jt_pair_contacts_f64(code, *map(ptr, args), ptr(od), ptr(op), ptr(on)) == 0
            d[0, p, b], pos[0, p, :, b], nrm[0, p, :, b] = od[0], op[:3], on[:3]
    return d, pos, nrm


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sphere_pair_matches_jax(kind):
    args = _poses(kind)
    jax_kernel, ours_kernel, code = KINDS[kind]
    cols = lambda s: tuple(jnp.asarray(s[:, k : k + 1]) for k in range(3))  # noqa: E731
    ref = jax_kernel(jnp.asarray(args[0]), jnp.asarray(args[1]), cols(args[2]), jnp.asarray(args[3]),
                     jnp.asarray(args[4]), cols(args[5]))
    ours = ours_kernel(*(torch.tensor(a) for a in args))
    twin = _host_twin_slots(code, *args)
    assert len(ours) == len(ref) == 1
    d0 = np.asarray(ref[0][0])
    assert (d0 < 0).any() and (d0 > 0).any()
    if kind == "sphere_sphere":  # coincident centres: the normal falls back to +z
        np.testing.assert_array_equal(np.asarray(ref[0][2])[2], np.tile([[0.0], [0.0], [1.0]], (1, B)))
    for name, a, b, t in zip(("dist", "pos", "normal"), ours[0], ref[0], (twin[0][0], twin[1][0], twin[2][0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0, err_msg=f"plain {name}")
        np.testing.assert_allclose(t, np.asarray(b), atol=1e-12, rtol=0, err_msg=f"host twin {name}")


@pytest.fixture(scope="module")
def scene():
    """(the port's check scene, the JAX package's, lowered from the same MJCF, float64)."""
    pm = check_scene.load(np.float64)
    jm = jax_put_model(mujoco.MjModel.from_xml_string(check_scene.CHECK_SCENE_XML), dtype=jnp.float64)
    jm = jm.replace(jnt_actfrclimited=pm.jnt_actfrclimited)
    return pm, jm


def _states(pm, rng, R: int, lift: float = 0.0):
    """(R, nq), (R, nv): joints turned from their springs' rest, the bodies
    raised by ``lift``."""
    qp = np.tile(np.asarray(pm.qpos0, np.float64), (R, 1))
    qp[:, :3] += 0.01 * rng.standard_normal((R, 3))
    qp[:, 2] += lift
    for adr in (3, 7):  # the free joint's and the ball joint's quaternions
        q = qp[:, adr : adr + 4] + 0.2 * rng.standard_normal((R, 4))
        qp[:, adr : adr + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qp[:, 11] = -0.02 + 0.02 * rng.standard_normal(R)  # the pusher towards the rod
    if lift:
        qp[:, 11] = 0.3
    qv = 0.3 * rng.standard_normal((R, pm.nv))
    return qp, qv


def test_passive_and_actuation_match_jax(scene):
    pm, jm = scene
    assert pm.jnt_type[:2] == (0, 1) and pm.jnt_actfrclimited == (1, 1, 0)
    assert np.asarray(pm.jnt_stiffness)[:2].all()
    rng = np.random.default_rng(41)
    qp, qv = _states(pm, rng, B)
    ctrl = 2.0 * rng.standard_normal((pm.nu, B))
    qpt, qvt = torch.tensor(qp.T), torch.tensor(qv.T)
    ours = le.passive_force_l(pm, qpt, qvt).numpy()
    ref = np.asarray(jle.passive_force_l(jm, jnp.asarray(qp.T), jnp.asarray(qv.T)))
    np.testing.assert_allclose(ours, ref, atol=1e-12, rtol=0)
    assert np.abs(ours[3:6]).max() > 1e-3  # the free joint's rotational spring acts (it has no damper)
    ours = le.actuation_l(pm, qpt, qvt, torch.tensor(ctrl)).numpy()
    ref = np.asarray(jle.actuation_l(jm, jnp.asarray(qp.T), jnp.asarray(qv.T), jnp.asarray(ctrl)))
    np.testing.assert_allclose(ours, ref, atol=1e-12, rtol=0)
    np.testing.assert_array_equal(ours[6:9], np.full((3, B), 0.01))  # every dof of the ball joint clamped


@pytest.mark.parametrize("contact", [False, True])
def test_rollout_matches_jax_lanes(scene, contact):
    pm, jm = scene
    rng = np.random.default_rng(42 + contact)
    R, T = 6, 8
    qp, qv = _states(pm, rng, R, lift=0.0 if contact else 1.0)
    ctrl = rng.standard_normal((R, T, pm.nu))
    ours = fr.rollout_lanes(pm, torch.tensor(qp), torch.tensor(qv), torch.tensor(ctrl), 1, 8)
    ref = jax.jit(lambda a, b, c: jax_rollout_lanes(jm, a, b, c, iterations=8, backend="xla"))(
        jnp.asarray(qp), jnp.asarray(qv), jnp.asarray(ctrl))
    tol = 1e-5 if contact else 1e-9
    np.testing.assert_allclose(ours.states.numpy(), np.asarray(ref.states), atol=tol, rtol=0)
    if contact:
        assert np.abs(ours.efc0.numpy()).max() > 1e-6  # contacts carried force


def test_host_twin_rollout_matches_plain(scene):
    pm, _ = scene
    rng = np.random.default_rng(43)
    R, T = 5, 6
    qp, qv = _states(pm, rng, R)
    ctrl = torch.tensor(rng.standard_normal((T, pm.nu, R)))
    f0 = torch.zeros((max(num_constraint_rows(pm), 1), R), dtype=torch.float64)
    args = (torch.tensor(qp.T).contiguous(), torch.tensor(qv.T).contiguous(), ctrl, f0)
    ref = fr.rollout_lanes_reference(pm, *args, 1, 8)
    twin = fr.fused_rollout_host_twin(pm, *args, 1, 8)
    for a, b in zip(ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0)


def test_lane_supported_takes_scene_and_refuses_the_rest(scene):
    pm, _ = scene
    lane_supported(pm)
    actuated_ball = dataclasses.replace(pm, actuator_trnid=(1,), _packed={})
    with pytest.raises(NotImplementedError, match="actuator 0 on a ball/free joint"):
        lane_supported(actuated_ball)
    welded = put_model(mujoco.MjModel.from_xml_string(check_scene.CHECK_SCENE_XML.replace(
        "</actuator>", "</actuator><equality><weld body1=\"ball\" body2=\"pendulum\"/></equality>")), dtype=np.float64)
    with pytest.raises(NotImplementedError, match="equality constraints of types"):
        lane_supported(welded)


def test_committed_snapshot_is_current():
    fresh = check_scene.snapshot()
    with np.load(check_scene.SNAPSHOT_PATH, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
