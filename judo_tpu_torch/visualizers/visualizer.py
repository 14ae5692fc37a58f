"""Visualizer: the GUI's state, publishing config and task changes to the bus
(counterpart of ``judo_tpu/visualizers/visualizer.py``).

It owns the task and optimizer choice, the reset and pause buttons, the plan
time, and the three config groups whose widgets write into configs under
locks; a task or optimizer switch rebuilds the widget tree and applies the
per-task overrides (judo/visualizers/visualizer.py:24-362 in the reference).

One difference in structure, none in what a client sees: ``_on_states``
runs inside the plant's publish, under the plant's lock, so it only keeps
the latest state message. The body frames are read from it by
``update_scene``, which the GUI server calls when it builds a ``state``
message, on its streaming thread and outside the plant's lock: at most once
per streamed message instead of once per plant tick (the ``judo_tpu``
plant computes a state's frames when they are first read).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.app.structs import MujocoState
from judo_tpu_torch.config import set_config_overrides
from judo_tpu_torch.controller import ControllerConfig
from judo_tpu_torch.optimizers import get_registered_optimizers
from judo_tpu_torch.tasks import get_registered_tasks
from judo_tpu_torch.visualizers.scene import SceneModel, build_scene, scene_source
from judo_tpu_torch.visualizers.widgets import ConfigBinding, WidgetSpec, reflect_config


class Visualizer:
    def __init__(self, bus: MessageBus, init_task: str, init_optimizer: str) -> None:
        self.bus = bus
        self.task_name = init_task
        self.optimizer_name = init_optimizer
        self.available_tasks = get_registered_tasks()
        self.available_optimizers = get_registered_optimizers()
        self.plan_time_ms: float | None = None
        self.controller_config_overrides: dict[str, dict] = {}
        self.optimizer_config_overrides: dict[str, dict] = {}
        self.latest_state: MujocoState | None = None
        self._build_for_task()
        bus.subscribe("states", self._on_states)
        bus.subscribe("plan_time", self._on_plan_time)
        bus.subscribe("traces", self._on_traces)

    # --- construction / task switching ---
    def _build_for_task(self) -> None:
        task_cls, task_cfg_cls = self.available_tasks[self.task_name]
        _, opt_cfg_cls = self.available_optimizers[self.optimizer_name]

        self.task_config = task_cfg_cls()
        self.optimizer_config = opt_cfg_cls()
        self.controller_config = ControllerConfig()
        for cfg in (self.optimizer_config, self.controller_config):
            cfg.set_override(self.task_name)

        self.task_binding = ConfigBinding(self.task_config, self._publish_task_config)
        self.optimizer_binding = ConfigBinding(self.optimizer_config, self._publish_optimizer_config)
        self.controller_binding = ConfigBinding(self.controller_config, self._publish_controller_config)

        self.scene: SceneModel = build_scene(*scene_source(task_cls))

    def widget_tree(self) -> dict[str, list[WidgetSpec]]:
        """The three config tab groups (visualizer.py tab layout)."""
        return {
            "task": reflect_config(self.task_config),
            "optimizer": reflect_config(self.optimizer_config),
            "controller": reflect_config(self.controller_config),
        }

    # --- GUI actions ---
    def set_task(self, name: str) -> None:
        if name not in self.available_tasks:
            raise ValueError(f"unknown task {name}")
        self.task_name = name
        self._build_for_task()
        self.bus.publish("task", name)
        self._publish_all_configs()

    def set_optimizer(self, name: str) -> None:
        if name not in self.available_optimizers:
            raise ValueError(f"unknown optimizer {name}")
        self.optimizer_name = name
        self._build_for_task()
        self.bus.publish("optimizer", name)
        self._publish_all_configs()

    def reset_task(self) -> None:
        self.bus.publish("task_reset", True)

    def pause_simulation(self) -> None:
        self.bus.publish("sim_pause", True)

    def register_controller_config_overrides(self, task: str, values: dict) -> None:
        """Launch-config overrides applied on task switch (visualizer.py:75-97)."""
        self.controller_config_overrides[task] = values
        set_config_overrides(task, ControllerConfig, values)

    def register_optimizer_config_overrides(self, task: str, values: dict) -> None:
        self.optimizer_config_overrides[task] = values
        set_config_overrides(task, type(self.optimizer_config), values)

    # --- publications ---
    def _publish_task_config(self) -> None:
        self.bus.publish("task_config", self.task_config)

    def _publish_optimizer_config(self) -> None:
        self.bus.publish("optimizer_config", self.optimizer_config)

    def _publish_controller_config(self) -> None:
        self.bus.publish("controller_config", self.controller_config)

    def _publish_all_configs(self) -> None:
        self._publish_task_config()
        self._publish_optimizer_config()
        self._publish_controller_config()

    # --- consumption ---
    def _on_states(self, msg: MujocoState) -> None:
        self.latest_state = msg  # read nothing here: this runs on the plant's thread, under its lock

    def update_scene(self) -> None:
        """Move the scene's bodies to the latest state's frames; a state of
        another task (another body count) leaves them where they are."""
        msg, scene = self.latest_state, self.scene
        if msg is None:
            return
        xpos = msg.xpos
        if xpos is not None and len(xpos) == len(scene.bodies):
            scene.set_data(np.asarray(xpos), np.asarray(msg.xquat))

    def _on_plan_time(self, seconds: float) -> None:
        self.plan_time_ms = seconds * 1e3

    def _on_traces(self, traces: np.ndarray) -> None:
        # as in the JAX package: no elite count, so every state message carries "num_elite": 0 (ROADMAP Queue 3)
        self.scene.set_traces(traces)
