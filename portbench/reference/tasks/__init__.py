"""The reference's tasks, one module per task, found by the configuration's
``task`` name. Each gives the task's snapshot and policy files (read as
data), its warm start, control bounds, command mapping and reward."""
