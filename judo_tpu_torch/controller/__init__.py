"""The planner and its host controller."""

from judo_tpu_torch.controller.controller import Controller, ControllerConfig, SolverState, make_controller
from judo_tpu_torch.controller.overrides import set_default_controller_overrides

set_default_controller_overrides()

__all__ = ["Controller", "ControllerConfig", "SolverState", "make_controller"]
