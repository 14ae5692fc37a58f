"""Minimal RFC 6455 WebSocket support on the standard library (the port's own
copy of ``judo_tpu/visualizers/websocket.py``).

The GUI server carries widget and scene state to the browser over a
websocket, the role viser's server plays in the reference. This module is
the server side of the protocol (handshake with Sec-WebSocket-Accept,
masked client frames decoded, unmasked server frames encoded, ping/pong and
close), enough for JSON text messages between the GUI server and the
browser, and a small masked client (``client_handshake``) for tests and
smoke runs.
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept value for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((client_key + _WS_MAGIC).encode()).digest()
    return base64.b64encode(digest).decode()


def handshake_response(client_key: str) -> bytes:
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(client_key)}\r\n"
        "\r\n"
    ).encode()


def encode_frame(payload: bytes, opcode: int = OP_TEXT) -> bytes:
    """Single unmasked server->client frame (FIN set)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


class WebSocketConnection:
    """A server-side websocket over an already-upgraded socket."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._buf = b""
        self.open = True

    # --- raw IO ---
    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("websocket closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    # --- protocol ---
    def send_text(self, text: str) -> None:
        if not self.open:
            raise ConnectionError("websocket closed")
        self.sock.sendall(encode_frame(text.encode()))

    def recv_message(self) -> str | None:
        """Next text message; None when the peer sent a close frame.

        Handles fragmentation, answers pings, ignores pongs/binary.
        """
        parts: list[bytes] = []
        while True:
            b1, b2 = self._recv_exact(2)
            fin = bool(b1 & 0x80)
            opcode = b1 & 0x0F
            masked = bool(b2 & 0x80)
            n = b2 & 0x7F
            if n == 126:
                n = struct.unpack(">H", self._recv_exact(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", self._recv_exact(8))[0]
            mask = self._recv_exact(4) if masked else b"\x00" * 4
            data = self._recv_exact(n)
            if masked:
                data = bytes(c ^ mask[i % 4] for i, c in enumerate(data))

            if opcode == OP_CLOSE:
                self.close(reply=True)
                return None
            if opcode == OP_PING:
                self.sock.sendall(encode_frame(data, OP_PONG))
                continue
            if opcode == OP_PONG:
                continue
            if opcode in (OP_TEXT, OP_CONT, OP_BINARY):
                parts.append(data)
                if fin:
                    return b"".join(parts).decode("utf-8", errors="replace")

    def close(self, reply: bool = False) -> None:
        if self.open:
            try:
                self.sock.sendall(encode_frame(b"", OP_CLOSE))
            except OSError:
                pass
            self.open = False
        if not reply:
            try:
                self.sock.close()
            except OSError:
                pass


def client_handshake(sock: socket.socket, host: str, path: str = "/ws") -> WebSocketConnection:
    """Client side of the handshake on a connected socket; -> a masked client connection."""
    key = base64.b64encode(b"judo-tpu-torch-key").decode()
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n"
        "\r\n"
    ).encode()
    sock.sendall(req)
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("handshake failed")
        resp += chunk
    header, _, rest = resp.partition(b"\r\n\r\n")
    if b"101" not in header.split(b"\r\n")[0]:
        raise ConnectionError(f"handshake rejected: {header[:200]!r}")
    if accept_key(key).encode() not in header:
        raise ConnectionError("bad Sec-WebSocket-Accept")
    conn = MaskedClientConnection(sock)
    conn._buf = rest
    return conn


class MaskedClientConnection(WebSocketConnection):
    """Client-side connection: frames must be masked per RFC 6455."""

    def send_text(self, text: str) -> None:
        payload = bytearray(text.encode())
        mask = b"\x12\x34\x56\x78"
        for i in range(len(payload)):
            payload[i] ^= mask[i % 4]
        n = len(payload)
        head = bytes([0x80 | OP_TEXT])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        self.sock.sendall(head + mask + bytes(payload))
