"""The planner and its host controller."""

from judo_tpu_torch.controller.controller import Controller, ControllerConfig, SolverState, make_controller

__all__ = ["Controller", "ControllerConfig", "SolverState", "make_controller"]
