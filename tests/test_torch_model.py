"""Model lowering of the PyTorch port held against the JAX package.

The port's ``put_model`` and ``physics_model_from_numpy`` (applied to a JAX
``PhysicsModel``) must give the same static fields and bit-identical arrays as
``judo_tpu.physics.put_model``; the committed mujoco-free snapshot must equal
a fresh export; and the package must import and roll out without JAX.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest

from judo_tpu.models.leap import leap_cube_xml_path
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.solver import num_constraint_rows as jax_nefc
from judo_tpu.physics.solver import num_noncontact_rows as jax_noncontact
from judo_tpu_torch.physics import model as tm
from judo_tpu_torch.tasks.leap_cube import LeapCube

from .test_physics.test_parity import CARTPOLE, SPHERE_PLANE

REPO = Path(__file__).resolve().parents[1]


def _leap_mj():
    return mujoco.MjModel.from_xml_path(leap_cube_xml_path())


def _assert_same_model(port: tm.PhysicsModel, jm) -> None:
    for name in tm.STATIC_FIELDS:
        assert getattr(port, name) == getattr(jm, name), name
    for name in tm.ARRAY_FIELDS:
        a, b = getattr(port, name), np.asarray(getattr(jm, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("xml", ["leap", "cartpole"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_put_model_matches_jax(xml, dtype):
    mj = _leap_mj() if xml == "leap" else mujoco.MjModel.from_xml_string(CARTPOLE)
    jm = jax_put_model(mj, dtype=jnp.dtype(dtype), solver_iterations=8)
    _assert_same_model(tm.put_model(mj, dtype=dtype, solver_iterations=8), jm)
    static = {name: getattr(jm, name) for name in tm.STATIC_FIELDS}
    arrays = {name: np.asarray(getattr(jm, name)) for name in tm.ARRAY_FIELDS}
    _assert_same_model(tm.physics_model_from_numpy(static, arrays), jm)


def test_row_counters_match_jax():
    mj = _leap_mj()
    jm = jax_put_model(mj, dtype=jnp.float64)
    pm = tm.put_model(mj, dtype=np.float64)
    assert tm.num_constraint_rows(pm) == jax_nefc(jm) == 236
    assert tm.num_noncontact_rows(pm) == jax_noncontact(jm) == 32
    assert tm.num_contact_slots(pm) == 68


def test_make_state_defaults_to_reference_pose():
    pm = tm.put_model(mujoco.MjModel.from_xml_string(CARTPOLE), dtype=np.float64)
    st = tm.make_state(pm, qvel=[0.5, -0.5], time=1.5)
    np.testing.assert_array_equal(st.qpos.numpy(), pm.qpos0)
    assert st.qvel.tolist() == [0.5, -0.5] and st.time == 1.5 and st.qpos.dtype == pm.torch_dtype


def test_mujoco_codes_match():
    for name, code in [
        ("mjSENS_JOINTPOS", tm.SENSOR_JOINTPOS), ("mjSENS_JOINTVEL", tm.SENSOR_JOINTVEL),
        ("mjSENS_FRAMEPOS", tm.SENSOR_FRAMEPOS), ("mjSENS_FRAMEQUAT", tm.SENSOR_FRAMEQUAT),
        ("mjSENS_FRAMEXAXIS", tm.SENSOR_FRAMEXAXIS), ("mjSENS_FRAMEZAXIS", tm.SENSOR_FRAMEZAXIS),
        ("mjSENS_GEOMDIST", tm.SENSOR_DISTANCE),
    ]:
        assert int(getattr(mujoco.mjtSensor, name)) == code, name
    assert int(mujoco.mjtObj.mjOBJ_SITE) == tm.OBJ_SITE and int(mujoco.mjtObj.mjOBJ_XBODY) == tm.OBJ_XBODY
    assert int(mujoco.mjtDisableBit.mjDSBL_CONTACT) == tm._DSBL_CONTACT
    assert int(mujoco.mjtCone.mjCONE_PYRAMIDAL) == tm._CONE_PYRAMIDAL


def test_lane_supported_raises_naming_pairs():
    pm = tm.put_model(mujoco.MjModel.from_xml_string(SPHERE_PLANE), dtype=np.float64)
    with pytest.raises(NotImplementedError, match=r"collision pair types \[\(0, 2\)\]"):
        tm.lane_supported(pm)
    tm.lane_supported(tm.put_model(_leap_mj(), dtype=np.float64))


def test_committed_snapshot_is_current():
    """The snapshot the GPU machine plans from equals a fresh export."""
    fresh = LeapCube.snapshot()
    with np.load(LeapCube.snapshot_path(), allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
    m, _ = tm.load_snapshot(LeapCube.snapshot_path(), dtype=np.float32)
    _assert_same_model(m, jax_put_model(_leap_mj(), dtype=jnp.float32, solver_iterations=25))


def test_imports_and_rolls_out_without_jax():
    code = (
        "import sys\n"
        "for k in ('jax', 'flax', 'jaxlib', 'mujoco'): sys.modules[k] = None\n"
        "import numpy as np, torch\n"
        "from judo_tpu_torch.physics.fused_rollout import rollout_lanes\n"
        "from judo_tpu_torch.tasks.leap_cube import LeapCube, QPOS_REST\n"
        "task = LeapCube(dtype=torch.float64)\n"
        "m = task.planning_model\n"
        "qp = torch.tensor(np.tile(QPOS_REST, (2, 1)))\n"
        "out = rollout_lanes(m, qp, torch.zeros(2, m.nv, dtype=torch.float64),\n"
        "                    torch.tensor(np.tile(QPOS_REST[7:], (2, 2, 1))))\n"
        "assert out.states.shape == (2, 2, m.nq + m.nv) and bool(torch.isfinite(out.states).all())\n"
        "assert not any(k.startswith(('jax', 'flax')) and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_do_not_import_jax():
    for path in (REPO / "judo_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text and "flax" not in text, path
    assert "judo_tpu." not in (REPO / "chip_smoke.py").read_text().replace("judo_tpu_torch", "")
