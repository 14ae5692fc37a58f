"""Write the mujoco-free snapshot of each ported task's planning model.

Run from the repository root where ``mujoco`` is installed:

    python -m judo_tpu_torch.models.export_snapshot

It lowers each task's MJCF with the port's own ``put_model`` and writes
``judo_tpu_torch/models/<task>.npz`` (float64 model, trace sensors, home pose,
reset command and timestep), and ``judo_tpu_torch/models/check_scene.npz``,
the kernels' check scene. Machines without ``mujoco`` build the models from
those files.
"""

from __future__ import annotations

import numpy as np

from judo_tpu_torch.models import check_scene
from judo_tpu_torch.tasks import get_registered_tasks


def main() -> None:
    for task_cls, _ in get_registered_tasks().values():
        path = task_cls.snapshot_path()
        np.savez_compressed(path, **task_cls.snapshot())
        print(f"wrote {path}")
    np.savez_compressed(check_scene.SNAPSHOT_PATH, **check_scene.snapshot())
    print(f"wrote {check_scene.SNAPSHOT_PATH}")


if __name__ == "__main__":
    main()
