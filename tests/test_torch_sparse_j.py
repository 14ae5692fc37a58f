"""J's structure in the kernels' step body (csrc/jt_step.cuh:assemble): a
contact row of J can be nonzero only on the dofs that move one of its
slot's bodies, ``body_dof_mask[b1] | body_dof_mask[b2]``. The assembly
computes its entries only there; the others stay as ``rollout_init`` zeroed
them.

- For every committed snapshot, every nonzero of the plain version's dense J
  at seeded states lies inside that structure (a limit or equality row: one
  or two dofs).
- The share of J's dense entries the structure allows, per model.
- The host twin of K1 on leap (elliptic cones), spot_navigate (pyramidal)
  and a 43-dof scene (a slot's dofs past the first 32) against the plain
  version, and its repeat in the other scratch layout bitwise.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics.lane_collision import find_contacts_l
from judo_tpu_torch.physics.lane_step import assemble_constraints_l
from judo_tpu_torch.physics.model import (
    HINGE,
    SLIDE,
    contact_rows_per,
    load_snapshot,
    num_constraint_rows,
    num_contact_slots,
)

from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)
from .torch_inputs import STAND, TARGETS, lanes, leap_batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SNAPSHOTS = sorted((Path(fr.__file__).resolve().parents[1] / "models").glob("*.npz"))


def plain_jacobian(m, B: int, seed: int):
    """(J (nefc, nv, B), the contact slots) of the plain version at seeded states."""
    qp, qv = seeded_states(m, B, seed)
    kin = le.kinematics_l(m, qp)
    contacts = find_contacts_l(m, kin) if m.contact_enabled and num_contact_slots(m) > 0 else None
    return assemble_constraints_l(m, le.com_l(m, kin), contacts, qp, qv).J.numpy(), contacts


def structure(m, J, contacts) -> np.ndarray:
    """(nefc, nv) bool: the entries of J that the structure allows to be
    nonzero. A row before the contacts keeps the dofs where ``J`` is nonzero,
    which must be one or two; a contact row the dofs that move one of its
    slot's bodies."""
    nefc = num_constraint_rows(m)
    nc = len(contacts.body1) if contacts is not None else 0
    nnc = nefc - contact_rows_per(m) * nc
    bdm = np.asarray(m.body_dof_mask) > 0
    allowed = np.zeros((nefc, m.nv), bool)
    for r in range(nnc):
        dofs = np.flatnonzero(np.abs(J[r]).max(axis=1) > 0)
        assert 1 <= len(dofs) <= 2
        allowed[r, dofs] = True
    for ci in range(nc):
        union = bdm[contacts.body1[ci]] | bdm[contacts.body2[ci]]
        for f in range(contact_rows_per(m)):
            allowed[nnc + 4 * ci + f if m.cone_pyramidal else nnc + f * nc + ci] = union
    return allowed


def seeded_states(m, B: int, seed: int):
    """qpos0 with every hinge and slide joint moved by up to about 0.05, and
    random velocities, batch-last float64."""
    rng = np.random.default_rng(seed)
    qp = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
    for j in range(m.njnt):
        if int(m.jnt_type[j]) in (SLIDE, HINGE):
            qp[:, m.jnt_qposadr[j]] += 0.05 * rng.standard_normal(B)
    qv = 0.5 * rng.standard_normal((B, m.nv))
    return torch.tensor(qp.T.copy()), torch.tensor(qv.T.copy())


@pytest.mark.parametrize("path", SNAPSHOTS, ids=[p.stem for p in SNAPSHOTS])
def test_plain_jacobian_lies_in_the_structure(path):
    m = load_snapshot(path, dtype=np.float64)[0]
    if num_constraint_rows(m) == 0:
        return
    J, contacts = plain_jacobian(m, 3, seed=71)
    assert np.isfinite(J).all() and np.abs(J).max() > 0
    assert not np.any(J[~structure(m, J, contacts)]), "a nonzero of the plain J outside the structure"


@pytest.mark.parametrize("name,walked,dense", [("leap_cube", 1772, 236 * 22), ("spot_navigate", 2398, 282 * 25),
                                               ("spot_box_push", 6318, 542 * 31), ("fr3_pick", 3802, 516 * 15),
                                               ("cylinder_push", 64, 24 * 4)])
def test_share_of_j_the_assembly_writes(name, walked, dense):
    m = load_snapshot(next(p for p in SNAPSHOTS if p.stem == name), dtype=np.float64)[0]
    J, contacts = plain_jacobian(m, 1, seed=73)
    allowed = structure(m, J, contacts)
    assert allowed.size == dense
    assert int(allowed.sum()) == walked


def spot_batch(B: int, T: int, seed: int):
    """Spot standing, small velocities, joint targets around the stand."""
    rng = np.random.default_rng(seed)
    qp = np.tile(STAND, (B, 1))
    qv = 0.05 * rng.standard_normal((B, 25))
    ct = np.tile(TARGETS, (B, T, 1)) + 0.05 * rng.standard_normal((B, T, 19))
    return qp, qv, ct


# Seven free spheres resting on a plane, touching in a row, and a pusher on a
# slide joint: 43 dofs, so a contact slot's dofs span two 32-dof words.
SPHERES = """
<mujoco>
  <option timestep="0.01"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
""" + "".join(f"""    <body pos="{0.198 * i:.3f} 0 0.098"><freejoint/><geom type="sphere" size="0.1" mass="1"/></body>
""" for i in range(7)) + """    <body pos="-0.3 0 0.1"><joint name="push" type="slide" axis="1 0 0"/>
      <geom type="sphere" size="0.1" mass="1"/></body>
  </worldbody>
  <actuator><motor joint="push" gear="1"/></actuator>
</mujoco>
"""


def spheres():
    import mujoco

    from judo_tpu_torch.physics.model import put_model

    return put_model(mujoco.MjModel.from_xml_string(SPHERES), dtype=np.float64, solver_iterations=8)


def twin_case(name: str, B: int, T: int, seed: int):
    """(model, qpos, qvel, ctrl) batch-last float64 for the host twin tests."""
    if name == "spheres":
        m = spheres()
        rng = np.random.default_rng(seed)
        qp = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
        qv = 0.1 * rng.standard_normal((B, m.nv))
        ct = rng.standard_normal((B, T, m.nu))
        return (m, *lanes(qp, qv, ct))
    m = load_snapshot(next(p for p in SNAPSHOTS if p.stem == name), dtype=np.float64)[0]
    return (m, *lanes(*(leap_batch(B, T, seed) if name == "leap_cube" else spot_batch(B, T, seed))))


@pytest.mark.parametrize("name", ["leap_cube", "spot_navigate", "spheres"])
def test_host_twin_step_matches_plain_and_repeats(name):
    B, T = 3, 4
    m, qp, qv, ct = twin_case(name, B, T, seed=72)
    assert bool(m.cone_pyramidal) == (name != "leap_cube")  # leap elliptic, the others pyramidal
    f0 = torch.zeros((num_constraint_rows(m), B), dtype=torch.float64)
    ref = fr.rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8)
    twin = fr.fused_rollout_host_twin(m, qp, qv, ct, f0, 1, 8)
    again = fr.fused_rollout_host_twin(m, qp, qv, ct, f0, 1, 8, layout=fr.GLOBAL_J)
    assert float(ref[3].abs().max()) > 1e-3  # the constraints carry force
    for label, a, b, c in zip(("qpos", "qvel", "sensors", "efc0"), ref, twin, again):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=label)
        assert torch.equal(b, c), label
