"""The port's GUI server on the CPU: its hello message against the JAX
server's, the HTTP routes, a websocket session over a real socket, and
``cli run --gui`` end to end."""

import contextlib
import io
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import judo_tpu.visualizers.server as jax_server
from judo_tpu.app.bus import MessageBus as JaxMessageBus
from judo_tpu.visualizers import Visualizer as JaxVisualizer
from judo_tpu_torch import cli
from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.app.nodes import SimulationNode
from judo_tpu_torch.config import get_override_registry
from judo_tpu_torch.visualizers import Visualizer
from judo_tpu_torch.visualizers import server as gui_server
from judo_tpu_torch.visualizers.server import GuiServer
from judo_tpu_torch.visualizers.websocket import client_handshake


@pytest.fixture(autouse=True)
def _overrides():
    """Register the JAX package's per-task defaults, which its conftest
    clears around each test; put the port's registry back after each test."""
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


@pytest.fixture
def server():
    bus = MessageBus()
    viz = Visualizer(bus, "cylinder_push", "ps")
    srv = GuiServer(bus, visualizer=viz, port=0, stream_hz=60.0)
    srv.start()
    yield srv, bus, viz
    srv.stop()


def _connect(port: int):
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    sock.settimeout(10)
    return client_handshake(sock, f"127.0.0.1:{port}")


def _recv_type(conn, expected: str, tries: int = 500) -> dict:
    for _ in range(tries):
        msg = json.loads(conn.recv_message())
        if msg["type"] == expected:
            return msg
    raise AssertionError(f"never received {expected}")


@pytest.mark.parametrize("task, optimizer", [("cylinder_push", "ps"), ("leap_cube", "mppi"), ("spot_navigate", "cem"),
                                             ("fr3_pick", "cem")])
def test_hello_matches_jax(task, optimizer):
    """The hello a client receives (scene, widget tree, task and optimizer
    lists) is the JAX server's, as JSON."""
    np.random.seed(0)
    ours = GuiServer.hello_message(types.SimpleNamespace(visualizer=Visualizer(MessageBus(), task, optimizer)))
    ref = jax_server.GuiServer.hello_message(
        types.SimpleNamespace(visualizer=JaxVisualizer(JaxMessageBus(), task, optimizer)))
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))


def test_http_serves_page_and_scene(server):
    srv, bus, viz = server
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/", timeout=10) as r:
        page = r.read()
        assert r.status == 200 and r.headers["Content-Type"].startswith("text/html")
    assert page == (gui_server._STATIC / "index.html").read_bytes()
    assert b"<canvas" in page and b"WebSocket" in page
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/api/scene", timeout=10) as r:
        hello = json.loads(r.read())
    assert hello == json.loads(json.dumps(srv.hello_message()))
    assert len(hello["scene"]["bodies"]) == len(viz.scene.bodies) == 4 and hello["task"] == "cylinder_push"
    with pytest.raises(urllib.error.HTTPError, match="404"):
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=10)


def test_websocket_session(server):
    """Over a real socket: hello; state messages that follow the plant's
    ticks; a widget edit; the buttons; a bad message answered with an error
    frame; a task switch answered with a new hello."""
    srv, bus, viz = server
    node = SimulationNode(bus, "cylinder_push", backend="judo_tpu", device="cpu")
    conn = _connect(srv.port)
    hello = _recv_type(conn, "hello")
    assert hello["task"] == "cylinder_push" and len(hello["scene"]["bodies"]) == 4

    node.sim.task.qvel[:] = [0.0, 0.0, 0.4, -0.3]  # the pusher moves
    for _ in range(3):
        node.step_once()
    frames = node.sim.sim_state.xpos
    deadline = time.time() + 20
    while time.time() < deadline:
        poses = np.asarray(_recv_type(conn, "state")["bodies"])
        if np.allclose(poses[:, :3], frames, atol=1e-12):
            break
    else:
        raise AssertionError("no state message carried the plant's body frames")
    assert poses.shape == (4, 7) and not np.allclose(frames, np.asarray(hello["scene"]["bodies"][2]["xpos"]))

    conn.send_text(json.dumps({"type": "set", "group": "optimizer", "path": ["sigma"], "value": 0.42}))
    conn.send_text(json.dumps({"type": "set", "group": "controller", "path": ["max_opt_iters"], "value": 3}))
    conn.send_text(json.dumps({"type": "reset"}))
    conn.send_text(json.dumps({"type": "pause"}))
    conn.send_text(json.dumps({"type": "bogus"}))
    err = _recv_type(conn, "error")
    assert "unknown message type 'bogus'" in err["message"]
    assert viz.optimizer_config.sigma == pytest.approx(0.42) and bus.read("optimizer_config") is viz.optimizer_config
    assert viz.controller_config.max_opt_iters == 3 and isinstance(viz.controller_config.max_opt_iters, int)
    assert bus.read("task_reset") is True and bus.read("sim_pause") is True
    assert node.sim.paused and node.sim.task.time == 0.0  # the plant took both buttons

    conn.send_text(json.dumps({"type": "task", "name": "cartpole"}))
    hello2 = _recv_type(conn, "hello")
    assert hello2["task"] == "cartpole" and len(hello2["scene"]["bodies"]) == 3
    assert bus.read("task") == "cartpole" and node.sim.task.name == "cartpole"
    conn.close()


def test_cli_run_with_gui_serves_and_frees_its_port(monkeypatch):
    """``run --gui --gui-port 0`` on the CPU: the printed address serves a
    websocket client hello and state messages and takes a task switch; the
    run ends with 'shutdown complete' and frees its port."""
    started = []

    class Recorded(GuiServer):
        def start(self) -> None:
            super().start()
            started.append(self)

    monkeypatch.setattr(gui_server, "GuiServer", Recorded)
    out, result = io.StringIO(), {}

    def run():
        with contextlib.redirect_stdout(out):
            result["report"] = cli.main(["--platform", "cpu", "run", "--task", "cartpole", "--optimizer", "ps",
                                         "--sim-backend", "judo_tpu", "--gui", "--gui-port", "0", "--seconds", "2"])

    thread = threading.Thread(target=run)
    thread.start()
    try:
        deadline = time.time() + 120
        while not started and time.time() < deadline and thread.is_alive():
            time.sleep(0.05)
        assert started, "the GUI server never started"
        port = started[0].port
        conn = _connect(port)
        assert _recv_type(conn, "hello")["task"] == "cartpole"
        state = _recv_type(conn, "state")
        assert np.asarray(state["bodies"]).shape == (3, 7)
        conn.send_text(json.dumps({"type": "task", "name": "cylinder_push"}))
        assert _recv_type(conn, "hello")["task"] == "cylinder_push"
    finally:
        thread.join(timeout=120)
    assert not thread.is_alive()
    lines = out.getvalue().strip().splitlines()
    assert f"GUI: http://localhost:{port}" in lines and lines[-1] == "shutdown complete"
    assert result["report"].plans > 0 and result["report"].ticks > 0
    with socket.socket() as s:  # nothing listens on the port any more (closed connections may linger in TIME_WAIT)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("0.0.0.0", port))
        s.listen()
