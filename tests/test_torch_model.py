"""Model lowering of the PyTorch port held against the JAX package.

The port's ``put_model`` and ``physics_model_from_numpy`` (applied to a JAX
``PhysicsModel``) must give the same static fields and bit-identical arrays as
``judo_tpu.physics.put_model``; the committed mujoco-free snapshots must equal
a fresh export; and the package must import, build its controllers and roll
out with neither JAX nor the JAX package importable.
"""

import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest

from judo_tpu.models.leap import leap_cube_xml_path
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.solver import num_constraint_rows as jax_nefc
from judo_tpu.physics.solver import num_noncontact_rows as jax_noncontact
from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks
from judo_tpu_torch.physics import model as tm
from judo_tpu_torch.tasks import (
    CaltechLeapCube, Cartpole, CylinderPush, FR3Pick, LeapCube, LeapCubeDown, SpotBoxPush, SpotNavigate, SpotTireRoll,
    SpotTireUpright,
)

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
    st = tm.make_state(pm, qvel=[0.5, -0.5], time=1.5, device="cpu")
    np.testing.assert_array_equal(st.qpos.numpy(), pm.qpos0)
    assert st.qvel.tolist() == [0.5, -0.5] and st.time == 1.5 and st.qpos.dtype == pm.torch_dtype
    with mock.patch("torch.cuda.is_available", return_value=False):  # the card is the default device
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            tm.make_state(pm)


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


SPHERE_ELLIPSOID = """
<mujoco>
  <worldbody>
    <body pos="0 0 0.3"><freejoint/><geom type="sphere" size="0.1"/></body>
    <body pos="0 0 0.6"><freejoint/><geom type="ellipsoid" size="0.1 0.1 0.2"/></body>
  </worldbody>
</mujoco>
"""

TWO_SPHERES = """
<mujoco>
  <worldbody>
    <body pos="0 0 0.3"><freejoint/><geom type="sphere" size="0.1"/></body>
    <body pos="0 0 0.6"><freejoint/><geom type="sphere" size="0.1"/></body>
  </worldbody>
</mujoco>
"""


def test_lane_supported_raises_naming_pairs():
    pm = tm.put_model(mujoco.MjModel.from_xml_string(SPHERE_ELLIPSOID), dtype=np.float64)
    with pytest.raises(NotImplementedError, match=r"collision pair types \[\(2, 4\)\]"):
        tm.lane_supported(pm)
    tm.lane_supported(tm.put_model(mujoco.MjModel.from_xml_string(TWO_SPHERES), dtype=np.float64))
    tm.lane_supported(tm.put_model(_leap_mj(), dtype=np.float64))
    sphere_plane = tm.put_model(mujoco.MjModel.from_xml_string(SPHERE_PLANE), dtype=np.float64)
    assert sphere_plane.cone_pyramidal  # plane pairs and the pyramidal cone are ported
    tm.lane_supported(sphere_plane)


@pytest.mark.parametrize("task", [
    LeapCube, SpotNavigate, Cartpole, CylinderPush, FR3Pick, LeapCubeDown, CaltechLeapCube, SpotBoxPush, SpotTireRoll,
    SpotTireUpright,
])
def test_committed_snapshot_is_current(task):
    """The snapshot the GPU machine plans from equals a fresh export and the
    JAX package's planning model of the same task."""
    fresh = task.snapshot()
    with np.load(task.snapshot_path(), allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
    m, _ = tm.load_snapshot(task.snapshot_path(), dtype=np.float32)
    _assert_same_model(m, jax_registered_tasks()[task.name][0]().planning_model)


def test_imports_and_rolls_out_without_jax():
    """With jax, flax, mujoco and the JAX package all unimportable: every module
    of the port imports, both controllers build on the CPU, and a leap
    rollout and a Spot policy rollout run."""
    code = (
        "import sys\n"
        "for k in ('jax', 'flax', 'jaxlib', 'mujoco', 'judo_tpu'): sys.modules[k] = None\n"
        "import importlib, pkgutil, numpy as np, torch, judo_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(judo_tpu_torch.__path__, 'judo_tpu_torch.')]\n"
        "for name in mods: importlib.import_module(name)\n"
        "from judo_tpu_torch.controller import make_controller\n"
        "from judo_tpu_torch.physics.fused_rollout import rollout_lanes\n"
        "from judo_tpu_torch.physics.policy_rollout import policy_rollout_lanes\n"
        "from judo_tpu_torch.tasks.leap_cube import QPOS_REST\n"
        "leap = make_controller('leap_cube', 'mppi', device='cpu', dtype=torch.float64)\n"
        "spot = make_controller('spot_navigate', 'mppi', device='cpu', dtype=torch.float64)\n"
        "m = leap.task.planning_model\n"
        "qp = torch.tensor(np.tile(QPOS_REST, (2, 1)))\n"
        "out = rollout_lanes(m, qp, torch.zeros(2, m.nv, dtype=torch.float64),\n"
        "                    torch.tensor(np.tile(QPOS_REST[7:], (2, 2, 1))))\n"
        "assert out.states.shape == (2, 2, m.nq + m.nv) and bool(torch.isfinite(out.states).all())\n"
        "s = spot.task\n"
        "sp = policy_rollout_lanes(s.planning_model, s.policy, torch.tensor(np.tile(s.qpos, (2, 1))),\n"
        "    torch.zeros(2, s.nv, dtype=torch.float64), s.task_to_sim_ctrl(torch.zeros(2, 1, 3, dtype=torch.float64)),\n"
        "    torch.zeros(2, 12, dtype=torch.float64))\n"
        "assert sp.states.shape == (2, 1, 51) and bool(torch.isfinite(sp.states).all())\n"
        "assert len(mods) > 25\n"
        "assert not any(k.startswith(('jax', 'flax', 'judo_tpu.')) and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_do_not_import_jax():
    pattern = re.compile(r"^\s*(from|import) (jax|judo_tpu|flax)([ .]|$)", re.M)
    for path in [*(REPO / "judo_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
    assert "judo_tpu." not in (REPO / "chip_smoke.py").read_text().replace("judo_tpu_torch", "")
