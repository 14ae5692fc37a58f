"""Task registry: every task of the JAX package except four Spot tasks
(spot_base, spot_box_push, spot_tire_roll, spot_tire_upright), still to port."""

from typing import Type

from judo_tpu_torch.tasks.base import Task, TaskConfig
from judo_tpu_torch.tasks.caltech_leap_cube import CaltechLeapCube, CaltechLeapCubeConfig
from judo_tpu_torch.tasks.cartpole import Cartpole, CartpoleConfig
from judo_tpu_torch.tasks.cylinder_push import CylinderPush, CylinderPushConfig
from judo_tpu_torch.tasks.fr3_pick import FR3Pick, FR3PickConfig
from judo_tpu_torch.tasks.leap_cube import LeapCube, LeapCubeConfig
from judo_tpu_torch.tasks.leap_cube_down import LeapCubeDown, LeapCubeDownConfig
from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate, SpotNavigateConfig

_registered_tasks: dict[str, tuple[Type[Task], Type[TaskConfig]]] = {}


def register_task(name: str, task_type: Type[Task], task_config_type: Type[TaskConfig] | None = None) -> None:
    _registered_tasks[name] = (task_type, task_config_type or task_type.config_t)


def get_registered_tasks() -> dict[str, tuple[Type[Task], Type[TaskConfig]]]:
    return _registered_tasks


for _cls in (Cartpole, CylinderPush, FR3Pick, LeapCube, LeapCubeDown, CaltechLeapCube, SpotNavigate):
    register_task(_cls.name, _cls)

__all__ = [
    "CaltechLeapCube", "CaltechLeapCubeConfig", "Cartpole", "CartpoleConfig", "CylinderPush", "CylinderPushConfig",
    "FR3Pick", "FR3PickConfig", "LeapCube", "LeapCubeConfig", "LeapCubeDown", "LeapCubeDownConfig", "SpotNavigate",
    "SpotNavigateConfig", "Task", "TaskConfig", "get_registered_tasks", "register_task",
]
