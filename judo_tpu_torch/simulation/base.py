"""Simulation base (counterpart of ``judo_tpu/simulation/base.py``).

A plant steps one environment at wall-clock rate under the controller's
commands. Its state lives in the task (``qpos``, ``qvel``, ``time``, the mocap
bodies), so the task's plant hooks read and write the same state the
controller's messages carry.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from judo_tpu_torch.tasks import Task, get_registered_tasks


def sim_ctrl(task: Task, command: np.ndarray) -> np.ndarray:
    """The task's command mapped to the plant's controls (``task_to_sim_ctrl``,
    run on the CPU in float64), flat."""
    out = task.task_to_sim_ctrl(torch.as_tensor(np.asarray(command, np.float64)))
    return np.asarray(out, np.float64).ravel()


class Simulation(ABC):
    """The 'real' physics process the controller acts on."""

    def __init__(self, task: Task) -> None:
        self.task = task
        self.paused = False

    def set_task(self, task_name: str) -> None:
        """Switch tasks by registry name, on the current task's device and dtype."""
        entry = get_registered_tasks().get(task_name)
        assert entry is not None, f"Task {task_name} not found in task registry."
        self.set_task_instance(entry[0](device=self.task.device, dtype=self.task.dtype))

    def set_task_instance(self, task: Task) -> None:
        """Switch to an already-constructed task."""
        self.task = task

    def pause(self, paused: bool | None = None) -> None:
        self.paused = (not self.paused) if paused is None else paused

    @abstractmethod
    def step(self, command: np.ndarray) -> None:
        """Advance the simulation one step under the given task-space command."""

    @property
    @abstractmethod
    def timestep(self) -> float:
        """Wall-clock pacing interval for the sim loop."""
