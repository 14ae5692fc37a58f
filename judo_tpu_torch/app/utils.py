"""Task and optimizer registration from launch-config dicts (the port's copy
of ``judo_tpu/app/utils.py``): classes named by dotted import path are
imported and registered."""

from __future__ import annotations

import importlib
from typing import Any, Mapping


def import_from_string(path: str) -> Any:
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ValueError(f"'{path}' is not a dotted import path")
    return getattr(importlib.import_module(module_name), attr)


def register_tasks_from_cfg(cfg: Mapping[str, Any]) -> None:
    """cfg maps task name -> {"task": dotted_path, "config": dotted_path} (or a dotted path)."""
    from judo_tpu_torch.tasks import register_task

    for name, entry in cfg.items():
        task_cls = import_from_string(entry["task"] if isinstance(entry, Mapping) else entry)
        has_config = isinstance(entry, Mapping) and "config" in entry
        config_cls = import_from_string(entry["config"]) if has_config else task_cls.config_t
        register_task(name, task_cls, config_cls)


def register_optimizers_from_cfg(cfg: Mapping[str, Any]) -> None:
    """cfg maps optimizer name -> {"optimizer": dotted_path, "config": dotted_path}."""
    from judo_tpu_torch.optimizers import register_optimizer

    for name, entry in cfg.items():
        opt_cls = import_from_string(entry["optimizer"] if isinstance(entry, Mapping) else entry)
        if not (isinstance(entry, Mapping) and "config" in entry):
            raise ValueError(f"optimizer registration for '{name}' requires a 'config' entry")
        register_optimizer(name, opt_cls, import_from_string(entry["config"]))
