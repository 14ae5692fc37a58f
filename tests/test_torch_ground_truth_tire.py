"""The port's plain lanes rollout held against MuJoCo's ``mj_step`` on the
two Spot tire scenes, as ``test_torch_ground_truth_spot.py`` holds
spot_box_push: 50 steps, every qpos within 0.05, and JAX's lanes path
(shared by the two tasks, whose model and reset are the same) within 1e-9.
"""

import pytest

from .test_torch_ground_truth_spot import spot_scene_against_mj_step
from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def lanes_cache():
    return {}


@pytest.mark.parametrize("task_name", ["spot_tire_roll", "spot_tire_upright"])
def test_spot_tire_scene_against_mj_step(task_name, lanes_cache):
    spot_scene_against_mj_step(task_name, lanes_cache)
