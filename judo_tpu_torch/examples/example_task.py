"""Custom-task registration demo: a subclass inherits cylinder_push's model
and reward, extends its config with a new parameter, and is registered under
a new name. Numeric config fields reach the reward through ``task_params``."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from judo_tpu_torch.tasks.cylinder_push import CylinderPush, CylinderPushConfig


@dataclass
class MyCylinderPushConfig(CylinderPushConfig):
    """Cylinder-push config with one extra user parameter."""

    my_custom_param: int = 42


class MyCylinderPush(CylinderPush):
    """Cylinder-push variant demonstrating subclass registration."""

    name: str = "my_cylinder_push"
    config_t: type[MyCylinderPushConfig] = MyCylinderPushConfig

    @classmethod
    def snapshot_path(cls) -> Path:
        return CylinderPush.snapshot_path()  # the same model
