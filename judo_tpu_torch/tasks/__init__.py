"""Task registry: every task the JAX package registers, in its order
(``spot_base``, a base class, is registered in neither)."""

from typing import Type

from judo_tpu_torch.tasks.base import Task, TaskConfig
from judo_tpu_torch.tasks.caltech_leap_cube import CaltechLeapCube, CaltechLeapCubeConfig
from judo_tpu_torch.tasks.cartpole import Cartpole, CartpoleConfig
from judo_tpu_torch.tasks.cylinder_push import CylinderPush, CylinderPushConfig
from judo_tpu_torch.tasks.fr3_pick import FR3Pick, FR3PickConfig
from judo_tpu_torch.tasks.leap_cube import LeapCube, LeapCubeConfig
from judo_tpu_torch.tasks.leap_cube_down import LeapCubeDown, LeapCubeDownConfig
from judo_tpu_torch.tasks.spot.spot_box_push import SpotBoxPush, SpotBoxPushConfig
from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate, SpotNavigateConfig
from judo_tpu_torch.tasks.spot.spot_tire_roll import SpotTireRoll, SpotTireRollConfig
from judo_tpu_torch.tasks.spot.spot_tire_upright import SpotTireUpright, SpotTireUprightConfig

_registered_tasks: dict[str, tuple[Type[Task], Type[TaskConfig]]] = {}


def register_task(name: str, task_type: Type[Task], task_config_type: Type[TaskConfig] | None = None) -> None:
    _registered_tasks[name] = (task_type, task_config_type or task_type.config_t)


def get_registered_tasks() -> dict[str, tuple[Type[Task], Type[TaskConfig]]]:
    return _registered_tasks


for _cls in (
    Cartpole, CylinderPush, FR3Pick, LeapCube, LeapCubeDown, CaltechLeapCube, SpotNavigate, SpotBoxPush, SpotTireRoll,
    SpotTireUpright,
):
    register_task(_cls.name, _cls)

__all__ = [
    "CaltechLeapCube", "CaltechLeapCubeConfig", "Cartpole", "CartpoleConfig", "CylinderPush", "CylinderPushConfig",
    "FR3Pick", "FR3PickConfig", "LeapCube", "LeapCubeConfig", "LeapCubeDown", "LeapCubeDownConfig", "SpotBoxPush",
    "SpotBoxPushConfig", "SpotNavigate", "SpotNavigateConfig", "SpotTireRoll", "SpotTireRollConfig", "SpotTireUpright",
    "SpotTireUprightConfig", "Task", "TaskConfig", "get_registered_tasks", "register_task",
]
