"""The output check tells a sound run from an unsound one: at a small size on
the CPU, the program passes its cell's limits, while the control (the
reference in bfloat16 in the program's place) and each fault a planning cell
can have, planted in the program underneath the harness, come out as not
correct: a plan that returns its nominal unchanged; half of the rollouts left
out, their rewards the mean of the rest; one rollout's reward off by 10 % on
every plan (a fault bound to one warp or block); the plan's answer, its
knots, altered where the update produces them. (No exchange between cards: every
cell runs on one.)"""

from __future__ import annotations

import pytest
import torch

from judo_tpu_torch.optimizers.mppi import MPPI
from judo_tpu_torch.tasks.leap_cube import LeapCube
from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

# sizes at which the rollouts' rewards spread: half of them set to the mean of the rest shows
CELLS = [("leap_cube-mppi.r320", 8, 0.4, LeapCube), ("spot_navigate-mppi.r24", 4, 0.16, SpotNavigate)]


def failing(res: dict) -> set:
    return {k for k, v in res["checks"].items() if v["value"] is None or v["value"] > v["limit"]}


@pytest.mark.parametrize("cell,R,horizon,task", CELLS, ids=[c[0] for c in CELLS])
def test_program_passes(small_run, cell, R, horizon, task):
    res = small_run(cell, R, horizon)
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("cell,R,horizon,task", CELLS, ids=[c[0] for c in CELLS])
def test_control_fails(small_run, cell, R, horizon, task):
    res = small_run(cell, R, horizon, producer="control")
    assert not res["correct"] and failing(res), res["checks"]


@pytest.mark.parametrize("cell,R,horizon,task", CELLS, ids=[c[0] for c in CELLS])
def test_plan_returning_its_state_unchanged_fails(small_run, monkeypatch, cell, R, horizon, task):
    monkeypatch.setattr(MPPI, "update", lambda self, params, state, samples, rewards: (samples[0], state))
    res = small_run(cell, R, horizon)
    assert not res["correct"] and "knot_gap" in failing(res), res["checks"]


@pytest.mark.parametrize("cell,R,horizon,task", CELLS, ids=[c[0] for c in CELLS])
def test_half_the_batch_left_out_fails(small_run, monkeypatch, cell, R, horizon, task):
    reward = task.reward

    def half(self, states, sensors, controls, params, metadata=None):
        r = reward(self, states[: R // 2], sensors[: R // 2], controls[: R // 2], params, metadata)
        return torch.cat([r, r.mean().expand(states.shape[0] - R // 2)])

    monkeypatch.setattr(task, "reward", half)
    res = small_run(cell, R, horizon)
    assert not res["correct"] and {"reward_gap_median", "reward_gap_p90"} & failing(res), res["checks"]


@pytest.mark.parametrize("cell,R,horizon,task", CELLS, ids=[c[0] for c in CELLS])
def test_one_rollout_off_on_every_plan_fails(small_run, monkeypatch, cell, R, horizon, task):
    reward = task.reward

    def one_off(self, states, sensors, controls, params, metadata=None):
        r = reward(self, states, sensors, controls, params, metadata)
        return torch.cat([r[:-1], r[-1:] * 1.1])

    monkeypatch.setattr(task, "reward", one_off)
    res = small_run(cell, R, horizon)
    assert not res["correct"] and "reward_gap_index" in failing(res), res["checks"]


@pytest.mark.parametrize("cell,R,horizon,task", CELLS, ids=[c[0] for c in CELLS])
def test_answer_altered_where_produced_fails(small_run, monkeypatch, cell, R, horizon, task):
    update = MPPI.update

    def altered(self, params, state, samples, rewards):
        knots, state = update(self, params, state, samples, rewards)
        return knots + torch.eye(*knots.shape, dtype=knots.dtype) * 1e-2, state

    monkeypatch.setattr(MPPI, "update", altered)
    res = small_run(cell, R, horizon)
    assert not res["correct"] and "knot_gap" in failing(res), res["checks"]
