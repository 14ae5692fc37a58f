"""Task registry (the port holds leap_cube and spot_navigate so far)."""

from typing import Type

from judo_tpu_torch.tasks.base import Task, TaskConfig
from judo_tpu_torch.tasks.leap_cube import LeapCube, LeapCubeConfig
from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate, SpotNavigateConfig

_registered_tasks: dict[str, tuple[Type[Task], Type[TaskConfig]]] = {}


def register_task(name: str, task_type: Type[Task], task_config_type: Type[TaskConfig] | None = None) -> None:
    _registered_tasks[name] = (task_type, task_config_type or task_type.config_t)


def get_registered_tasks() -> dict[str, tuple[Type[Task], Type[TaskConfig]]]:
    return _registered_tasks


register_task(LeapCube.name, LeapCube)
register_task(SpotNavigate.name, SpotNavigate)

__all__ = ["LeapCube", "LeapCubeConfig", "SpotNavigate", "SpotNavigateConfig", "Task", "TaskConfig", "get_registered_tasks", "register_task"]
