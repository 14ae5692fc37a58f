"""CPU MuJoCo as the plant (counterpart of ``judo_tpu/simulation/mj_simulation.py``).

The plant compiles the task's plant MJCF (``Task.plant_xml``: leap_cube's
finer ``leap_cube_sim``, every other task's planning model) with ``mujoco``,
imported when the plant is built, and keeps its own ``MjData``. The task's
state is loaded into it whenever the task changed it (a reset), and copied
back into the task after every step, so the task's plant hooks see the
plant's state. Where ``mujoco`` is not installed the plant refuses to start;
the ``judo_tpu`` backend needs no ``mujoco``.
"""

from __future__ import annotations

import numpy as np

from judo_tpu_torch.app.structs import MujocoState
from judo_tpu_torch.simulation.base import Simulation, sim_ctrl
from judo_tpu_torch.tasks import Task


def import_mujoco():
    try:
        import mujoco
    except ImportError as e:
        raise ImportError(
            "the 'mujoco' and 'mujoco_policy' simulation backends need the mujoco package, which is not installed; "
            "the 'judo_tpu' backend steps the plant with the port's own engine (--sim-backend judo_tpu)"
        ) from e
    return mujoco


class MJSimulation(Simulation):
    def __init__(self, task: Task) -> None:
        super().__init__(task)
        self._bind_task()

    def _bind_task(self) -> None:
        self.mujoco = import_mujoco()
        self.model = self.mujoco.MjModel.from_xml_string(self.task.plant_xml())
        self.data = self.mujoco.MjData(self.model)
        self._load_task_state()

    def set_task_instance(self, task: Task) -> None:
        super().set_task_instance(task)
        self._bind_task()

    def _load_task_state(self) -> None:
        """The task's state into the plant's MjData, kinematics refreshed (as
        a JAX task's ``reset`` leaves its MjData)."""
        d, task = self.data, self.task
        d.qpos[:] = task.qpos
        d.qvel[:] = task.qvel
        d.time = task.time
        self._sync_mocap()
        self.mujoco.mj_forward(self.model, d)

    def _sync_mocap(self) -> None:
        if self.model.nmocap:
            self.data.mocap_pos[:] = self.task.mocap_pos
            self.data.mocap_quat[:] = self.task.mocap_quat

    def _pull_task_state(self) -> None:
        """Load the task's state where the task changed it since the last step."""
        d, task = self.data, self.task
        if not (np.array_equal(task.qpos, d.qpos) and np.array_equal(task.qvel, d.qvel) and task.time == d.time):
            self._load_task_state()
        self._sync_mocap()

    def _push_task_state(self) -> None:
        d = self.data
        self.task.qpos, self.task.qvel, self.task.time = d.qpos.copy(), d.qvel.copy(), float(d.time)

    def step(self, command: np.ndarray) -> None:
        """task ctrl -> sim ctrl -> pre_sim_step -> mj_step -> post_sim_step
        (mj_simulation.py:32-46)."""
        if self.paused:
            return
        self._pull_task_state()
        ctrl = sim_ctrl(self.task, command)
        if ctrl.shape[0] != self.model.nu:
            raise ValueError(
                f"task_to_sim_ctrl produced {ctrl.shape[0]} dims but sim model has "
                f"nu={self.model.nu}; policy tasks need the 'mujoco_policy' backend"
            )
        self.data.ctrl[:] = ctrl
        self.task.pre_sim_step()
        self.mujoco.mj_step(self.model, self.data)
        self._push_task_state()
        self.task.post_sim_step()
        self._pull_task_state()

    @property
    def timestep(self) -> float:
        return float(self.model.opt.timestep)

    @property
    def sim_state(self) -> MujocoState:
        """Snapshot for the controller and visualizer (mj_simulation.py:52-65)."""
        d = self.data
        return MujocoState(
            time=float(d.time),
            qpos=d.qpos.copy(),
            qvel=d.qvel.copy(),
            xpos=d.xpos.copy(),
            xquat=d.xquat.copy(),
            mocap_pos=d.mocap_pos.copy(),
            mocap_quat=d.mocap_quat.copy(),
            sim_metadata=self.task.get_sim_metadata(),
        )
