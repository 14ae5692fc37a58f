"""The port's visualizer layer against the JAX package's, on the CPU: widget
trees of every config, the scene of every task from its snapshot with
mujoco unimportable, the body frames of a state message against
``mj_forward``, where those frames are computed, the topics the
Visualizer publishes, and two behaviours of the reference the port keeps
(ROADMAP Queue 3)."""

import dataclasses
import json
import sys
import types

import mujoco
import numpy as np
import pytest
import torch

import judo_tpu.visualizers.server as jax_server
from judo_tpu.app.bus import MessageBus as JaxMessageBus
from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.optimizers import get_registered_optimizers as jax_registered_optimizers
from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks
from judo_tpu.visualizers import Visualizer as JaxVisualizer
from judo_tpu.visualizers import build_scene as jax_build_scene
from judo_tpu.visualizers import reflect_config as jax_reflect_config
from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.app.nodes import ControllerNode, SimulationNode
from judo_tpu_torch.config import get_override_registry
from judo_tpu_torch.controller import ControllerConfig
from judo_tpu_torch.optimizers import get_registered_optimizers
from judo_tpu_torch.physics.model import put_model
from judo_tpu_torch.simulation import JTSimulation, jt_simulation
from judo_tpu_torch.tasks import get_registered_tasks
from judo_tpu_torch.tasks.base import render_fields
from judo_tpu_torch.tasks.leap_cube import LeapCube
from judo_tpu_torch.visualizers import Visualizer, build_scene, reflect_config, scene_source
from judo_tpu_torch.visualizers.server import GuiServer, widget_to_dict
from judo_tpu_torch.visualizers.widgets import ConfigBinding

TASKS = list(get_registered_tasks())


@pytest.fixture(autouse=True)
def _overrides():
    """The JAX package's conftest clears its override registry around each
    test: register its per-task defaults again, as its import does. The
    Visualizer registers launch-config overrides process-wide: put the
    port's registry back after each test."""
    from judo_tpu.controller.overrides import set_default_controller_overrides
    from judo_tpu.optimizers.overrides import set_default_optimizer_overrides

    set_default_optimizer_overrides()
    set_default_controller_overrides()
    saved = {cls: {k: dict(v) for k, v in per.items()} for cls, per in get_override_registry().items()}
    yield
    get_override_registry().clear()
    for cls, per in saved.items():
        for key, values in per.items():
            get_override_registry()[cls][key] = values


def _wire(specs) -> list:
    """Widget specs as a client receives them (JSON round trip)."""
    return json.loads(json.dumps([widget_to_dict(w) for w in specs]))


def _jax_wire(specs) -> list:
    return json.loads(json.dumps([jax_server.widget_to_dict(w) for w in specs]))


def _configs(name: str):
    """(port config, JAX config) of a task, an optimizer or the controller."""
    if name in TASKS:
        return get_registered_tasks()[name][1](), jax_registered_tasks()[name][1]()
    if name == "controller":
        return ControllerConfig(), JaxControllerConfig()
    return get_registered_optimizers()[name][1](), jax_registered_optimizers()[name][1]()


@pytest.mark.parametrize("name", [*TASKS, "ps", "mppi", "cem", "controller"])
def test_widget_tree_matches_jax(name):
    """Every registered task config, the three optimizer configs and the
    controller config reflect into the JAX package's widget tree exactly."""
    ours, ref = _configs(name)
    assert _wire(reflect_config(ours)) == _jax_wire(jax_reflect_config(ref))


def test_binding_writes_values_and_sets_event():
    from judo_tpu_torch.tasks.cylinder_push import CylinderPushConfig

    cfg = CylinderPushConfig()
    published = []
    binding = ConfigBinding(cfg, lambda: published.append(True))
    binding.set_value(("goal_pos", "1"), -0.2)
    binding.set_value(("w_pusher_proximity",), 0.7)
    assert cfg.goal_pos[1] == -0.2 and cfg.w_pusher_proximity == 0.7
    assert binding.changed.is_set() and len(published) == 2


@pytest.mark.parametrize("name", TASKS)
def test_scene_from_snapshot_matches_jax(name, monkeypatch):
    """The scene read from the committed snapshot, with mujoco unimportable,
    equals the JAX scene of the compiled model: names, ids, types and every
    size, position, orientation and colour, exactly."""
    np.random.seed(0)
    ref = jax_build_scene(jax_registered_tasks()[name][0]().model)
    monkeypatch.setitem(sys.modules, "mujoco", None)
    ours = build_scene(*scene_source(get_registered_tasks()[name][0]))
    assert [(b.name, b.body_id) for b in ours.bodies] == [(b.name, b.body_id) for b in ref.bodies]
    assert [[(g.name, g.body, g.geom_type) for g in b.geoms] for b in ours.bodies] == [
        [(g.name, g.body, g.geom_type) for g in b.geoms] for b in ref.bodies
    ]
    for bo, br in zip(ours.bodies, ref.bodies):
        for go, gr in zip(bo.geoms, br.geoms):
            for f in ("size", "pos", "quat", "rgba"):
                np.testing.assert_array_equal(getattr(go, f), getattr(gr, f), err_msg=f"{go.name} {f}")
    assert ours.to_dict() == ref.to_dict()


def test_scene_of_mesh_geoms_matches_jax():
    """A user's MJCF mesh reaches the wire as the JAX scene's triangle soup,
    and a hidden collision geom drops out with show_collision_geoms off."""
    xml = """
    <mujoco>
      <asset><mesh name="tet" vertex="0 0 0  1 0 0  0 1 0  0 0 1"/></asset>
      <worldbody>
        <body name="b"><freejoint/>
          <geom type="mesh" mesh="tet" rgba="0.8 0.2 0.2 1" contype="0" conaffinity="0"/>
          <geom name="hull" type="box" size="0.1 0.1 0.1"/>
        </body>
      </worldbody>
    </mujoco>
    """
    mj = mujoco.MjModel.from_xml_string(xml)
    m, extras = put_model(mj, dtype=np.float64), render_fields(mj)
    for show in (True, False):
        ours, ref = build_scene(m, extras, show), jax_build_scene(mj, show)
        assert ours.to_dict() == ref.to_dict()
    tri = build_scene(m, extras).bodies[1].geoms[0].mesh_tri
    assert tri.shape == (4, 3, 3)


def _leap_state_after_ticks(n: int):
    """A leap_cube JTSimulation (CPU, float64) after ``n`` ticks of its reset command."""
    task = LeapCube(device="cpu", dtype=torch.float64, seed=0)
    sim = JTSimulation(task)
    for _ in range(n):
        sim.step(task.reset_command)
    return sim


def test_state_message_frames_match_mujoco():
    """The body poses of a state message equal mj_forward's frames at the
    plant's state, the goal's mocap pose included, to 1e-12."""
    sim = _leap_state_after_ticks(3)
    bus = MessageBus()
    viz = Visualizer(bus, "leap_cube", "mppi")
    bus.publish("states", sim.sim_state)
    srv = GuiServer(bus, visualizer=viz, port=0)
    try:
        msg = srv.state_message()
    finally:
        srv.stop()
    task = sim.task
    mj = mujoco.MjModel.from_xml_string(LeapCube.model_xml())
    data = mujoco.MjData(mj)
    data.qpos[:] = task.qpos
    data.mocap_pos[:] = task.mocap_pos
    data.mocap_quat[:] = task.mocap_quat
    mujoco.mj_forward(mj, data)
    poses = np.asarray(msg["bodies"])
    assert poses.shape == (mj.nbody, 7) == (21, 7)
    np.testing.assert_allclose(poses[:, :3], data.xpos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(poses[:, 3:], data.xquat, rtol=0, atol=1e-12)
    assert not np.allclose(poses[2, :3], mj.body_pos[2])  # the cube moved off its model pose


@pytest.mark.parametrize("name", TASKS)
def test_body_frames_match_kinematics_l(name):
    """The host walk of the body tree for one environment gives the frames
    of the batched ``kinematics_l`` (free, hinge and slide joints) at a
    perturbed state, to rounding."""
    from judo_tpu_torch.physics.lane_engine import kinematics_l

    task = get_registered_tasks()[name][0](device="cpu", dtype=torch.float64)
    m = task.planning_model
    qpos = task.qpos + 0.3 * np.random.default_rng(0).standard_normal(task.nq)
    kin = kinematics_l(m, torch.as_tensor(qpos).reshape(-1, 1))
    xpos, xquat = jt_simulation.body_frames(m, np.zeros(0, np.int64), qpos, None, None)
    np.testing.assert_allclose(xpos, kin.xpos[:, :, 0].numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(xquat, kin.xquat[:, :, 0].numpy(), rtol=0, atol=1e-14)


def test_body_frames_are_computed_per_state_message_not_per_tick(monkeypatch):
    """With a Visualizer subscribed to the plant's states, 20 plant ticks
    compute no body frames; each state message computes one set, on the
    caller's thread."""
    calls = []
    real = jt_simulation.body_frames

    def counted(*args):
        calls.append(True)
        return real(*args)

    monkeypatch.setattr(jt_simulation, "body_frames", counted)
    bus = MessageBus()
    node = SimulationNode(bus, "cartpole", backend="judo_tpu", device="cpu")
    viz = Visualizer(bus, "cartpole", "ps")
    srv = GuiServer(bus, visualizer=viz, port=0)
    try:
        for _ in range(20):
            node.step_once()
        assert node.ticks == 20 and calls == []
        first = srv.state_message()
        assert len(calls) == 1
        node.step_once()
        second = srv.state_message()
        assert len(calls) == 2
    finally:
        srv.stop()
    assert first["bodies"] != second["bodies"]  # the pole swings


def test_encoded_state_is_the_state_messages_json():
    """The streamed text is ``json.dumps`` of the state message's dict, with
    no traces, with traces, and after new traces replace them (encoded anew)."""
    bus = MessageBus()
    node = SimulationNode(bus, "cartpole", backend="judo_tpu", device="cpu")
    viz = Visualizer(bus, "cartpole", "ps")
    srv = GuiServer(bus, visualizer=viz, port=0)
    rng = np.random.default_rng(0)
    try:
        for traces in (None, rng.standard_normal((4, 2, 3)), rng.standard_normal((6, 2, 3))):
            if traces is not None:
                bus.publish("traces", traces)
            bus.publish("plan_time", float(rng.uniform()))
            node.step_once()
            text = srv.encode_state()
            msg = json.loads(text)
            viz.update_scene()
            expected = {
                "type": "state",
                "bodies": [[*map(float, b.xpos), *map(float, b.xquat)] for b in viz.scene.bodies],
                "traces": None if traces is None else traces.tolist(),
                "num_elite": 0,
                "plan_time_ms": viz.plan_time_ms,
            }
            assert text == json.dumps(expected) and msg == expected
    finally:
        srv.stop()


class _Recording:
    """Wraps a bus's publish to record each topic's name in order."""

    def __init__(self, bus) -> None:
        self.topics: list[str] = []
        publish = bus.publish

        def record(name, value):
            self.topics.append(name)
            publish(name, value)

        bus.publish = record


@pytest.mark.parametrize("action", ["set_task", "set_optimizer", "reset", "pause", "widgets"])
def test_visualizer_publishes_the_jax_topics(action):
    """Each GUI action publishes the same topics, in the same order, as the
    JAX Visualizer, and leaves the same widget tree."""
    np.random.seed(0)
    results = []
    for viz_cls, bus_cls, wire in ((Visualizer, MessageBus, _wire), (JaxVisualizer, JaxMessageBus, _jax_wire)):
        bus = bus_cls()
        viz = viz_cls(bus, "cartpole", "ps")
        rec = _Recording(bus)
        if action == "set_task":
            viz.set_task("cylinder_push")
        elif action == "set_optimizer":
            viz.set_optimizer("mppi")
        elif action == "reset":
            viz.reset_task()
        elif action == "pause":
            viz.pause_simulation()
        else:
            viz.task_binding.set_value(("w_vertical",), 3.0)
            viz.optimizer_binding.set_value(("num_rollouts",), 7)
            viz.controller_binding.set_value(("horizon",), 0.5)
        tree = {k: wire(v) for k, v in viz.widget_tree().items()}
        values = {t: bus.read(t) for t in ("task", "optimizer", "task_reset", "sim_pause")}
        results.append((rec.topics, tree, values, viz.task_name, viz.optimizer_name, len(viz.scene.bodies)))
    assert results[0] == results[1]


def test_visualizer_launch_overrides_apply_on_switch():
    """Overrides registered through the Visualizer reach the configs it
    builds on the next switch, as in the JAX package."""
    np.random.seed(0)
    out = []
    for viz_cls, bus_cls in ((Visualizer, MessageBus), (JaxVisualizer, JaxMessageBus)):
        viz = viz_cls(bus_cls(), "cartpole", "mppi")
        viz.register_controller_config_overrides("cylinder_push", {"horizon": 0.77})
        viz.register_optimizer_config_overrides("cylinder_push", {"num_rollouts": 24})
        viz.set_task("cylinder_push")
        out.append((viz.controller_config.horizon, viz.optimizer_config.num_rollouts))
    assert out[0] == out[1] == (0.77, 24)


def test_config_topics_reach_no_node():
    """Reference behaviour kept (ROADMAP Queue 3): the Visualizer publishes
    task_config, optimizer_config and controller_config, but no node of
    either package subscribes to them, so a widget edit changes the GUI's
    copy of a config and never the running controller."""
    from judo_tpu.app import nodes as jax_nodes

    topics = {"task_config", "optimizer_config", "controller_config"}
    bus = MessageBus()
    SimulationNode(bus, "cartpole", backend="judo_tpu", device="cpu")
    ctrl = ControllerNode(bus, "cartpole", "ps", device="cpu")
    viz = Visualizer(bus, "cartpole", "ps")
    assert not topics & set(bus._subs)
    viz.optimizer_binding.set_value(("sigma",), 0.42)
    assert bus.read("optimizer_config").sigma == 0.42 and ctrl.controller.optimizer_cfg.sigma != 0.42

    np.random.seed(0)
    jbus = JaxMessageBus()
    jax_nodes.SimulationNode(jbus, "cartpole", backend="judo_tpu")
    jax_nodes.ControllerNode(jbus, "cartpole", "ps")
    JaxVisualizer(jbus, "cartpole", "ps")
    assert not topics & set(jbus._subs)


def test_state_messages_carry_no_elite_count():
    """Reference behaviour kept (ROADMAP Queue 3): traces reach the scene
    with no elite count and nothing calls trace_segments_to_scene, so every
    state message carries "num_elite": 0, in both packages."""
    traces = np.arange(5 * 2 * 3, dtype=np.float64).reshape(5, 2, 3)
    out = []
    for viz_cls, bus_cls in ((Visualizer, MessageBus), (JaxVisualizer, JaxMessageBus)):
        bus = bus_cls()
        viz = viz_cls(bus, "cartpole", "ps")
        bus.publish("traces", traces)
        bus.publish("plan_time", 0.025)
        if viz_cls is Visualizer:
            srv = GuiServer(bus, visualizer=viz, port=0)
            try:
                out.append(srv.state_message())
            finally:
                srv.stop()
        else:
            out.append(jax_server.GuiServer.state_message(types.SimpleNamespace(visualizer=viz)))
    assert out[0]["num_elite"] == out[1]["num_elite"] == 0
    assert out[0]["traces"] == out[1]["traces"] == traces.tolist()
    assert out[0] == out[1]


def test_visualizer_refuses_unknown_names():
    viz = Visualizer(MessageBus(), "cartpole", "ps")
    with pytest.raises(ValueError, match="unknown task"):
        viz.set_task("nope")
    with pytest.raises(ValueError, match="unknown optimizer"):
        viz.set_optimizer("nope")
    assert (viz.task_name, viz.optimizer_name) == ("cartpole", "ps")


def test_dataclass_fields_of_configs_match():
    """The premise of the widget parity: each config of the port has the
    JAX config's fields, in order."""
    for name in [*TASKS, "ps", "mppi", "cem", "controller"]:
        ours, ref = _configs(name)
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)], name
