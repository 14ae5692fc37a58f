"""The fused rollout (the module holding the CUDA kernel) held against the JAX
package's ``rollout_lanes(backend="xla")``, and the kernel's own arithmetic
(built with g++ from the same source) held against the plain version.

Tolerances: cartpole 1e-9 (no contacts); leap 1e-6 on states, sensors and
the step-0 forces over 10 contact steps (measured ~3e-14); host twin 1e-9.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.models.leap import leap_cube_xml_path
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.pallas_step import rollout_lanes as jax_rollout_lanes
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics.model import num_constraint_rows, put_model

from .test_physics.test_parity import CARTPOLE
from .torch_inputs import leap_batch


def _jax_rollout(jm, qp, qv, ct, efc_warm=None):
    fn = jax.jit(lambda a, b, c, f: jax_rollout_lanes(jm, a, b, c, backend="xla", iterations=8, efc_warm=f))
    out = fn(*(jnp.asarray(x) if x is not None else None for x in (qp, qv, ct, efc_warm)))
    return np.asarray(out.states), np.asarray(out.sensordata), np.asarray(out.efc0)


def test_rollout_lanes_cartpole_matches_jax():
    mj = mujoco.MjModel.from_xml_string(CARTPOLE)
    rng = np.random.default_rng(0)
    R, T = 4, 40
    qp = np.tile([0.2, 2.9], (R, 1)) + 0.5 * rng.standard_normal((R, 2))  # some hit the cart's limits
    qv = 0.1 * rng.standard_normal((R, mj.nv))
    ct = 0.3 * rng.standard_normal((R, T, mj.nu))
    js, jsens, _ = _jax_rollout(jax_put_model(mj, dtype=jnp.float64), qp, qv, ct)
    out = fr.rollout_lanes(put_model(mj, dtype=np.float64), torch.tensor(qp), torch.tensor(qv), torch.tensor(ct), iterations=8)
    np.testing.assert_allclose(out.states.numpy(), js, atol=1e-9, rtol=0)
    np.testing.assert_allclose(out.sensordata.numpy(), jsens, atol=1e-9, rtol=0)


def test_rollout_lanes_leap_matches_jax():
    mj = mujoco.MjModel.from_xml_path(leap_cube_xml_path())
    jm = jax_put_model(mj, dtype=jnp.float64, solver_iterations=8)
    pm = put_model(mj, dtype=np.float64, solver_iterations=8)
    R, T = 3, 10
    qp, qv, ct = leap_batch(R, T, seed=1)
    warm = np.abs(0.05 * np.random.default_rng(2).standard_normal((R, num_constraint_rows(pm))))
    js, jsens, jefc0 = _jax_rollout(jm, qp, qv, ct, warm)
    out = fr.rollout_lanes(pm, *(torch.tensor(x) for x in (qp, qv, ct)), efc_warm=torch.tensor(warm))
    assert np.abs(jefc0).max() > 1e-2  # contacts carry force
    np.testing.assert_allclose(out.states.numpy(), js, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.sensordata.numpy(), jsens, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.efc0.numpy(), jefc0, atol=1e-6, rtol=0)


@pytest.mark.parametrize("scene", ["leap", "cartpole", "leap_b1"])
def test_host_twin_matches_plain_version(scene):
    """The CUDA kernel's step body, compiled by g++ with the warp's 32 lanes
    played in one thread, against the plain PyTorch version: 3 steps,
    float64; 4 rollouts, or 1 (leap_b1). Cartpole has 2 constraint rows, fewer
    than the lanes, so most lanes idle in every row pass."""
    B = 1 if scene == "leap_b1" else 4
    if scene.startswith("leap"):
        m = put_model(mujoco.MjModel.from_xml_path(leap_cube_xml_path()), dtype=np.float64, solver_iterations=8)
        qp, qv, ct = leap_batch(B, 3, seed=3)
    else:
        m = put_model(mujoco.MjModel.from_xml_string(CARTPOLE), dtype=np.float64)
        rng = np.random.default_rng(4)
        qp, qv, ct = np.tile([1.7, 2.9], (B, 1)), rng.standard_normal((B, 2)), rng.standard_normal((B, 3, 1))
    nefc = max(num_constraint_rows(m), 1)
    f0 = torch.tensor(np.abs(0.05 * np.random.default_rng(5).standard_normal((nefc, B))))
    args = (torch.tensor(qp.T.copy()), torch.tensor(qv.T.copy()), torch.tensor(ct.transpose(1, 2, 0).copy()), f0)
    ref = fr.rollout_lanes_reference(m, *args, 1, 8)
    twin = fr.fused_rollout_host_twin(m, *args, 1, 8)
    for name, a, b in zip(("qpos", "qvel", "sensors", "efc0"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)


def test_shared_memory_limit_raises():
    """The scratch layout follows the card's per-block limit: the whole
    scratch in shared memory where it fits, else J in global memory, and a
    rollout whose scratch fits neither way raises, naming the bytes and the
    limit (leap in float64 needs more than the 48 KB a block gets without
    opting in, with or without its J)."""
    from judo_tpu_torch import _build

    lib = _build.load("host")
    m = put_model(mujoco.MjModel.from_xml_path(leap_cube_xml_path()), dtype=np.float64, solver_iterations=8)
    sizes = fr._sizes(m, 1, 1, 1, None)
    nbytes = fr.scratch_elems(lib, sizes, fr.SHARED) * 8
    rest = fr.scratch_elems(lib, sizes, fr.GLOBAL_J) * 8
    assert nbytes - rest == 8 * num_constraint_rows(m) * (m.nv | 1) and 48 * 1024 < rest < nbytes < 227 * 1024
    assert fr.choose_layout(lib, sizes, 8, "fused_rollout", None, 227 * 1024) == (fr.SHARED, nbytes)
    assert sizes.jglobal == 0
    assert fr.choose_layout(lib, sizes, 8, "fused_rollout", None, rest) == (fr.GLOBAL_J, rest)
    assert sizes.jglobal == 1
    with pytest.raises(RuntimeError, match=rf"{nbytes} bytes .* limit of 49152 bytes"):
        fr.choose_layout(lib, sizes, 8, "fused_rollout", None, 48 * 1024)


def test_wrapper_runs_plain_version_on_cpu_and_checks_shapes():
    m = put_model(mujoco.MjModel.from_xml_string(CARTPOLE), dtype=np.float64)
    qp, qv = torch.zeros(2, 3, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.float64)
    ct, f0 = torch.zeros(2, 1, 3, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.float64)
    before = fr.fused_rollout.launches
    out = fr.fused_rollout(m, qp, qv, ct, f0)
    assert fr.fused_rollout.launches == before  # CPU tensors never launch the kernel
    assert [tuple(x.shape) for x in out] == [(2, 2, 3), (2, 2, 3), (2, 6, 3), (2, 3)]
    with pytest.raises(ValueError, match="qvel has shape"):
        fr.fused_rollout(m, qp, qv[:1], ct, f0)
    with pytest.raises(ValueError, match="dtype"):
        fr.fused_rollout(m, qp, qv.float(), ct, f0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_gpu():
    """On the card: the CUDA kernel against the plain version, leap, f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from judo_tpu_torch.tasks.leap_cube import LeapCube

    m = LeapCube(device="cuda", dtype=torch.float64).planning_model
    qp, qv, ct = leap_batch(64, 3, seed=6)
    args = [torch.tensor(x, device="cuda") for x in (qp.T.copy(), qv.T.copy(), ct.transpose(1, 2, 0).copy())]
    f0 = torch.zeros((num_constraint_rows(m), 64), dtype=torch.float64, device="cuda")
    ref = fr.rollout_lanes_reference(m, *args, f0, 1, 8)
    out = fr.fused_rollout(m, *args, f0, 1, 8)
    for a, b in zip(ref, out):
        torch.testing.assert_close(b, a, atol=1e-8, rtol=0)
