"""The port's own engine as the plant (counterpart of
``judo_tpu/simulation/jt_simulation.py``).

One environment is stepped by ``physics_step`` on the task's planning model:
on the card the single-step kernel at a batch of one, on the CPU its plain
version. Contact forces start from zero on every tick (the JAX plant's state
carries none). The only plant that runs where ``mujoco`` is not installed.

On the card a tick runs on a CUDA stream of the plant's own: its state goes
up from pinned memory, the kernel runs, the new state comes back into pinned
memory, and the tick waits on an event of that stream. So a tick does not
queue behind a planning solve that another thread has launched on its
stream.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from judo_tpu_torch.app.structs import MujocoState
from judo_tpu_torch.physics.fused_rollout import physics_step
from judo_tpu_torch.physics.model import BALL, FREE, SLIDE, num_constraint_rows
from judo_tpu_torch.simulation.base import Simulation, sim_ctrl
from judo_tpu_torch.tasks import Task


class JTSimulation(Simulation):
    def __init__(self, task: Task) -> None:
        _refuse_policy_task(task)
        super().__init__(task)
        self._bind_task()

    def _bind_task(self) -> None:
        task = self.task
        pm = self.pm = task.planning_model
        self._kin_model = pm.astype(np.float64)
        nq, nv, nu_ = pm.nq, pm.nv, max(pm.nu, 1)
        dev, dtype = task.device, task.dtype
        self._f = torch.zeros((max(num_constraint_rows(pm), 1), 1), dtype=dtype, device=dev)
        self._stream = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(device=dev)
            # the plant's stream starts behind what this thread queued so far: the forces' fill, the model's upload
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            self._f.record_stream(self._stream)
            self._host_in = torch.zeros(nq + nv + nu_, dtype=dtype, pin_memory=True)
            self._host_out = torch.zeros(nq + nv, dtype=dtype, pin_memory=True)
            self.tick_done = torch.cuda.Event(enable_timing=True)  # ends each tick's work on the plant's stream
        self._load_task_state()

    def set_task_instance(self, task: Task) -> None:
        _refuse_policy_task(task)  # before the switch: a refused task leaves the plant on its old one
        super().set_task_instance(task)
        self._bind_task()

    def _load_task_state(self) -> None:
        self._qpos = np.asarray(self.task.qpos, np.float64).copy()
        self._qvel = np.asarray(self.task.qvel, np.float64).copy()
        self._time = float(self.task.time)

    def _advance(self, ctrl: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One physics step from the plant's state; -> (qpos, qvel) in float64."""
        pm, dtype = self.pm, self.task.dtype
        nq, nv = pm.nq, pm.nv
        ctrl_ = ctrl if pm.nu else np.zeros(1)
        if self._stream is None:
            col = lambda x: torch.as_tensor(x, dtype=dtype).reshape(-1, 1)  # noqa: E731
            oq, ov, _, _ = physics_step(pm, col(self._qpos), col(self._qvel), col(ctrl_), self._f)
            return oq[:, 0].double().numpy(), ov[:, 0].double().numpy()
        # the previous tick ended with its event, so the pinned buffers are free
        self._host_in.numpy()[:] = np.concatenate([self._qpos, self._qvel, ctrl_])
        with torch.cuda.stream(self._stream):
            x = self._host_in.to(self._f.device, non_blocking=True)
            oq, ov, _, _ = physics_step(
                pm, x[:nq].view(nq, 1), x[nq : nq + nv].view(nv, 1), x[nq + nv :].view(-1, 1), self._f
            )
            self._host_out[:nq].copy_(oq[:, 0], non_blocking=True)
            self._host_out[nq:].copy_(ov[:, 0], non_blocking=True)
            self.tick_done.record(self._stream)
        self.tick_done.synchronize()
        out = self._host_out.numpy().astype(np.float64)
        return out[:nq], out[nq:]

    def step(self, command: np.ndarray) -> None:
        """Re-sync if the task reset its state behind the plant's back, then
        task ctrl -> sim ctrl -> pre_sim_step -> physics step -> the state
        back into the task -> post_sim_step (jt_simulation.py:37-51)."""
        if self.paused:
            return
        task = self.task
        if not np.allclose(task.qpos, self._qpos, atol=1e-12):
            self._load_task_state()
        ctrl = sim_ctrl(task, command)
        if ctrl.shape[0] != self.pm.nu:
            raise ValueError(f"task_to_sim_ctrl produced {ctrl.shape[0]} dims but the model has nu={self.pm.nu}")
        task.pre_sim_step()
        self._qpos, self._qvel = self._advance(ctrl)
        self._time += self.timestep
        task.qpos, task.qvel, task.time = self._qpos.copy(), self._qvel.copy(), self._time
        task.post_sim_step()

    @property
    def timestep(self) -> float:
        return float(self.task.extras["timestep"])

    @property
    def sim_state(self) -> MujocoState:
        """The task's state; its body frames are computed when first read,
        from the model and mocap bodies of the task that published it."""
        task = self.task
        qpos = np.asarray(task.qpos, np.float64).copy()
        mocap_pos, mocap_quat = task.mocap_pos.copy(), task.mocap_quat.copy()
        model, mocap_ids = self._kin_model, task.mocap_body_ids.copy()
        return _DeferredFrames(
            lambda: body_frames(model, mocap_ids, qpos, mocap_pos, mocap_quat),
            time=float(task.time),
            qpos=qpos,
            qvel=np.asarray(task.qvel, np.float64).copy(),
            mocap_pos=mocap_pos,
            mocap_quat=mocap_quat,
            sim_metadata=task.get_sim_metadata(),
        )


def _refuse_policy_task(task: Task) -> None:
    if task.uses_locomotion_policy:
        raise ValueError(
            f"task {task.name!r} commands a locomotion policy, not its actuators; the judo_tpu plant steps "
            "actuator controls only: use the 'mujoco_policy' backend"
        )


def _qmul(u, v) -> tuple:
    """Hamilton product of two quaternions (w, x, y, z)."""
    uw, ux, uy, uz = u
    vw, vx, vy, vz = v
    return (uw * vw - ux * vx - uy * vy - uz * vz, uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx, uw * vz + ux * vy - uy * vx + uz * vw)


def _qrot(q, v) -> tuple:
    """``v`` rotated by the unit quaternion ``q`` (the formula of ``l_quat_rotate``)."""
    w, x, y, z = q
    a = (y * v[2] - z * v[1], z * v[0] - x * v[2], x * v[1] - y * v[0])
    b = (y * a[2] - z * a[1], z * a[0] - x * a[2], x * a[1] - y * a[0])
    return (v[0] + 2.0 * (w * a[0] + b[0]), v[1] + 2.0 * (w * a[1] + b[1]), v[2] + 2.0 * (w * a[2] + b[2]))


def _qnormalize(q) -> tuple:
    n = max(sum(c * c for c in q), 1e-15) ** 0.5
    return tuple(c / n for c in q)


def body_frames(model, mocap_ids: np.ndarray, qpos: np.ndarray, mocap_pos: np.ndarray, mocap_quat: np.ndarray):
    """(xpos (nbody, 3), xquat (nbody, 4)) of ``model`` at ``qpos``: the body
    tree of ``kinematics_l`` walked for one environment in Python floats on
    the host (``kinematics_l`` on one column costs milliseconds of small
    tensor operations), the mocap bodies ``mocap_ids`` at the given mocap
    pose; what ``mj_forward`` fills."""
    m = model
    body_pos, body_quat = m.np64("body_pos").tolist(), m.np64("body_quat").tolist()
    jnt_pos, jnt_axis, qpos0 = m.np64("jnt_pos").tolist(), m.np64("jnt_axis").tolist(), m.np64("qpos0").tolist()
    q = np.asarray(qpos, np.float64).tolist()
    xpos, xquat = [(0.0, 0.0, 0.0)], [(1.0, 0.0, 0.0, 0.0)]
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        pos = tuple(a + c for a, c in zip(xpos[p], _qrot(xquat[p], body_pos[b])))
        quat = _qmul(xquat[p], body_quat[b])
        for j in range(m.body_jntadr[b], m.body_jntadr[b] + m.body_jntnum[b]):
            jt, a = m.jnt_type[j], m.jnt_qposadr[j]
            if jt == FREE:
                pos, quat = tuple(q[a : a + 3]), _qnormalize(q[a + 3 : a + 7])
                continue
            if jt == SLIDE:
                axis = _qrot(quat, jnt_axis[j])
                pos = tuple(c + (q[a] - qpos0[a]) * d for c, d in zip(pos, axis))
                continue
            anchor = tuple(c + d for c, d in zip(_qrot(quat, jnt_pos[j]), pos))
            if jt == BALL:
                quat = _qmul(quat, _qnormalize(q[a : a + 4]))
            else:  # HINGE
                half = 0.5 * (q[a] - qpos0[a])
                s, ax = math.sin(half), jnt_axis[j]
                quat = _qmul(quat, (math.cos(half), ax[0] * s, ax[1] * s, ax[2] * s))
            pos = tuple(c - d for c, d in zip(anchor, _qrot(quat, jnt_pos[j])))
        xpos.append(pos)
        xquat.append(quat)
    xpos, xquat = np.asarray(xpos, np.float64), np.asarray(xquat, np.float64)
    if len(mocap_ids):
        xpos[mocap_ids] = mocap_pos
        xquat[mocap_ids] = mocap_quat / np.linalg.norm(mocap_quat, axis=-1, keepdims=True)
    return xpos, xquat


class _DeferredFrames(MujocoState):
    """A state message whose body frames (``xpos``, ``xquat``) are computed
    on first read: the controller never reads them, so the plant's tick
    does not pay for them; the GUI reads them at its own rate."""

    def __init__(self, frames, **fields) -> None:
        self._make_frames, self._frames = frames, None
        super().__init__(xpos=None, xquat=None, **fields)

    def _body_frames(self) -> tuple[np.ndarray, np.ndarray]:
        if self._frames is None:
            self._frames = self._make_frames()
        return self._frames

    xpos = property(lambda self: self._body_frames()[0], lambda self, _: None)
    xquat = property(lambda self: self._body_frames()[1], lambda self, _: None)
