"""Browser GUI server: the scene and live-tunable widgets over a websocket
(counterpart of ``judo_tpu/visualizers/server.py``).

The render backend of the Visualizer, the role viser's server plays in the
reference (judo/visualizers/visualizer.py:24-362, judo/gui.py:90-419,
judo/visualizers/model.py:38-302). A standard-library HTTP server serves a
single-page WebGL renderer (``static/index.html``, no outside scripts) and
streams states and traces over ``websocket.py``; widget changes come back
over the same socket into the ``ConfigBinding`` lock and event.

Protocol (JSON text frames):
  server -> client
    {"type": "hello", "scene": {...}, "widgets": {...}, "tasks": [...],
     "optimizers": [...], "task": str, "optimizer": str}
    {"type": "state", "bodies": [[x,y,z,qw,qx,qy,qz], ...],
     "traces": [[[x,y,z],[x,y,z]], ...] | null, "num_elite": int,
     "plan_time_ms": float | null}
    {"type": "error", "message": str}
  client -> server
    {"type": "set", "group": "task"|"optimizer"|"controller",
     "path": [...], "value": v}
    {"type": "task", "name": str} | {"type": "optimizer", "name": str}
    {"type": "reset"} | {"type": "pause"}

A ``state`` message is built on the streaming thread, at most ``stream_hz``
times a second: the body frames of the latest state are read there, outside
the plant's lock, and the traces are encoded once per plan. ``state_times``
keeps each message's build and encode time on the host.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

import numpy as np

from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.optimizers import get_registered_optimizers
from judo_tpu_torch.visualizers.visualizer import Visualizer
from judo_tpu_torch.visualizers.websocket import WebSocketConnection, handshake_response
from judo_tpu_torch.visualizers.widgets import WidgetSpec

_STATIC = Path(__file__).parent / "static"
# state messages whose build and encode times are kept
TIMES_KEPT = 100_000


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def widget_to_dict(w: WidgetSpec) -> dict:
    return {
        "kind": w.kind,
        "name": w.name,
        "path": list(w.path),
        "value": _jsonable(w.value),
        "min": w.minimum,
        "max": w.maximum,
        "step": w.step,
        "options": w.options,
        "children": [widget_to_dict(c) for c in w.children],
        # goal-marker metadata (np_1d_field xyz_vis_indices): the client
        # renders these arrays as draggable 3D markers (judo/gui.py:269-316)
        "element_names": w.element_names,
        "xyz_vis_indices": w.xyz_vis_indices,
    }


class GuiServer:
    """HTTP + WebSocket GUI around a Visualizer (the ViserServer equivalent).
    Without a ``visualizer`` it makes one for the task and optimizer that
    ``ctrl_node`` plans with (cylinder_push and ps without either)."""

    def __init__(
        self,
        bus: MessageBus,
        ctrl_node: Any = None,
        port: int = 8008,
        visualizer: Visualizer | None = None,
        stream_hz: float = 30.0,
    ) -> None:
        self.bus = bus
        if visualizer is None:
            init_task, opt_name = "cylinder_push", "ps"
            if ctrl_node is not None:
                init_task = ctrl_node.controller.task.name
                opt_cls = type(ctrl_node.controller.optimizer)
                opt_name = next((n for n, (cls, _) in get_registered_optimizers().items() if cls is opt_cls), "ps")
            visualizer = Visualizer(bus, init_task, opt_name)
        self.visualizer = visualizer
        self.stream_hz = stream_hz
        self.state_times: collections.deque = collections.deque(maxlen=TIMES_KEPT)
        self._clients: list[WebSocketConnection] = []
        self._clients_lock = threading.Lock()
        self._stop = threading.Event()
        self._traces_json: tuple | None = None  # (the traces array last encoded, its JSON)

        gui = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args: Any) -> None:  # quiet
                pass

            def do_GET(self) -> None:
                if self.path == "/ws":
                    gui._handle_websocket(self)
                    return
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html; charset=utf-8", (_STATIC / "index.html").read_bytes())
                elif self.path == "/api/scene":
                    self._send(200, "application/json", json.dumps(gui.hello_message()).encode())
                else:
                    self._send(404, None, b"")

            def _send(self, code: int, content_type: str | None, body: bytes) -> None:
                self.send_response(code)
                if content_type is not None:
                    self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._httpd.server_address[1]
        self._threads: list[threading.Thread] = []

    # --- lifecycle ---
    def start(self) -> None:
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True, name="gui-http"),
            threading.Thread(target=self._stream_loop, daemon=True, name="gui-stream"),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Close every client, stop serving (if started), free the port and join both threads."""
        self._stop.set()
        with self._clients_lock:
            for c in self._clients:
                c.close()
            self._clients.clear()
        if self._threads:
            self._httpd.shutdown()  # waits for serve_forever, so only once it runs
        self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10.0)

    # --- messages ---
    def hello_message(self) -> dict:
        v = self.visualizer
        return {
            "type": "hello",
            "scene": v.scene.to_dict(),
            "widgets": {k: [widget_to_dict(w) for w in ws] for k, ws in v.widget_tree().items()},
            "tasks": sorted(v.available_tasks),
            "optimizers": sorted(v.available_optimizers),
            "task": v.task_name,
            "optimizer": v.optimizer_name,
        }

    def state_message(self) -> dict:
        """The scene at the latest state (its body frames are read here)."""
        return json.loads(self.encode_state())

    def encode_state(self) -> str:
        """The ``state`` message as JSON text (``json.dumps`` of its dict).
        The traces' JSON is encoded once per traces array the controller
        publishes (one per plan), not once per message: the stream sends
        each more than once, and a plan's traces take milliseconds to encode."""
        v = self.visualizer
        v.update_scene()
        scene = v.scene
        traces = scene.traces
        if self._traces_json is None or traces is not self._traces_json[0]:
            self._traces_json = (traces, json.dumps(None if traces is None else np.asarray(traces).tolist()))
        bodies = [[*map(float, b.xpos), *map(float, b.xquat)] for b in scene.bodies]
        head = json.dumps({"type": "state", "bodies": bodies})
        tail = json.dumps({"num_elite": scene.num_elite_traces, "plan_time_ms": v.plan_time_ms})
        return f'{head[:-1]}, "traces": {self._traces_json[1]}, {tail[1:]}'

    # --- websocket plumbing ---
    def _handle_websocket(self, handler: BaseHTTPRequestHandler) -> None:
        key = handler.headers.get("Sec-WebSocket-Key")
        if not key:
            handler.send_response(400)
            handler.send_header("Content-Length", "0")
            handler.end_headers()
            return
        handler.connection.sendall(handshake_response(key))
        conn = WebSocketConnection(handler.connection)
        conn.send_text(json.dumps(self.hello_message()))
        with self._clients_lock:
            self._clients.append(conn)
        try:
            while not self._stop.is_set():
                msg = conn.recv_message()
                if msg is None:
                    break
                try:
                    self.handle_client_message(json.loads(msg))
                except Exception as e:  # noqa: BLE001 - bad client input must not kill the server
                    conn.send_text(json.dumps({"type": "error", "message": str(e)}))
        except (ConnectionError, OSError):
            pass
        finally:
            with self._clients_lock:
                if conn in self._clients:
                    self._clients.remove(conn)
        # keep the HTTP handler from writing anything else on this socket
        handler.close_connection = True

    def handle_client_message(self, msg: dict) -> None:
        """Apply one client action (also called directly by tests)."""
        v = self.visualizer
        kind = msg.get("type")
        if kind == "set":
            binding = {
                "task": v.task_binding,
                "optimizer": v.optimizer_binding,
                "controller": v.controller_binding,
            }[msg["group"]]
            path = tuple(str(p) for p in msg["path"])
            binding.set_value(path, self._coerce(binding.cfg, path, msg["value"]))
        elif kind == "task":
            v.set_task(msg["name"])
            self.broadcast(self.hello_message())
        elif kind == "optimizer":
            v.set_optimizer(msg["name"])
            self.broadcast(self.hello_message())
        elif kind == "reset":
            v.reset_task()
        elif kind == "pause":
            v.pause_simulation()
        else:
            raise ValueError(f"unknown message type {kind!r}")

    @staticmethod
    def _coerce(cfg: Any, path: tuple[str, ...], value: Any) -> Any:
        """Coerce a JSON value to the config field's current python type."""
        target = cfg
        for p in path[:-1]:
            if p.isdigit():
                return float(value)
            target = getattr(target, p)
        if path[-1].isdigit():
            return float(value)
        cur = getattr(target, path[-1])
        if isinstance(cur, bool):
            return bool(value)
        if isinstance(cur, int) and not isinstance(value, bool):
            return int(value)
        if isinstance(cur, float):
            return float(value)
        return value

    def broadcast(self, message: dict) -> None:
        self._send_all(json.dumps(message))

    def _send_all(self, data: str) -> None:
        with self._clients_lock:
            dead = []
            for c in self._clients:
                try:
                    c.send_text(data)
                except (ConnectionError, OSError):
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)

    def _stream_loop(self) -> None:
        period = 1.0 / self.stream_hz
        while not self._stop.is_set():
            t0 = time.perf_counter()
            with self._clients_lock:
                has_clients = bool(self._clients)
            if has_clients:
                data = self.encode_state()
                self.state_times.append(time.perf_counter() - t0)
                self._send_all(data)
            dt = time.perf_counter() - t0
            if dt < period:
                time.sleep(period - dt)
