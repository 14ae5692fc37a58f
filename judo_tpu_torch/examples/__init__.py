"""Subclass-registration demos (counterparts of ``judo_tpu/examples``): a
custom task and a custom optimizer, registered from code (``register_task``,
``register_optimizer``) or from a launch config's ``custom_tasks`` and
``custom_optimizers`` (``judo_tpu_torch/examples/example.yaml``)."""

from judo_tpu_torch.examples.example_optimizer import MyCrossEntropyMethod, MyCrossEntropyMethodConfig
from judo_tpu_torch.examples.example_task import MyCylinderPush, MyCylinderPushConfig

__all__ = ["MyCrossEntropyMethod", "MyCrossEntropyMethodConfig", "MyCylinderPush", "MyCylinderPushConfig"]
