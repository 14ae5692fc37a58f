"""ONNX policies in the port: extract the weights, build a PyTorch MLP
(counterpart of ``judo_tpu/utils/onnx_loader.py``).

The reference runs the Spot locomotion policy with ONNX Runtime. Here a
network is extracted once by the repository's native parser
(``native/onnx_extract.cpp``) into a ``.jtw`` container, and re-expressed as
an ``nn.Module`` MLP. The parser is compiled with ``g++`` on first use into
``build/judo_tpu_torch/onnx-<hash of the source>/`` at the repository root; a
missing ``g++`` or a failed build raises with the compiler's output.

``.jtw`` container (little-endian): the magic ``JTONNX1\\0``; a u32 count of
tensors, each a u32-length name, u32 ONNX dtype, u32 rank, u64 dims, u64
byte count and the raw bytes; a u32 count of nodes, each a u32-length op
type and u32-counted lists of u32-length input and output names.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from judo_tpu_torch._build import BUILD_DIR
from judo_tpu_torch.physics.model import resolve_device

EXTRACTOR_SOURCE = Path(__file__).resolve().parents[2] / "native" / "onnx_extract.cpp"
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_ONNX_DTYPES = {1: np.float32, 7: np.int64, 11: np.float64}

# Activation ops that may follow a Gemm (judo_tpu/utils/onnx_loader.py:96-104).
ACTIVATIONS = {
    "Relu": lambda x: torch.clamp(x, min=0.0),
    "Elu": lambda x: torch.where(x > 0, x, torch.expm1(x)),
    "Tanh": torch.tanh,
    "Sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "LeakyRelu": lambda x: torch.where(x > 0, x, 0.01 * x),
    "Softsign": lambda x: x / (1.0 + torch.abs(x)),
    "Identity": lambda x: x,
}


class OnnxGraph(NamedTuple):
    tensors: dict[str, np.ndarray]
    nodes: list[tuple[str, list[str], list[str]]]  # (op_type, inputs, outputs)


def extractor_path() -> Path:
    """The compiled extractor, built from ``native/onnx_extract.cpp`` if missing."""
    h = hashlib.sha256(EXTRACTOR_SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"onnx-{h.hexdigest()[:16]}" / "libonnx_extract.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: it builds the ONNX extractor from native/onnx_extract.cpp")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *GXX_FLAGS, "-o", tmp, str(EXTRACTOR_SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the ONNX extractor failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def extract_onnx(onnx_path: str | Path, out_path: str | Path | None = None) -> OnnxGraph:
    """Run the native extractor on ``onnx_path``, writing the container to
    ``out_path`` (the same path with a ``.jtw`` suffix by default), and read it."""
    onnx_path = Path(onnx_path)
    out_path = onnx_path.with_suffix(".jtw") if out_path is None else Path(out_path)
    lib = ctypes.CDLL(str(extractor_path()))
    lib.onnx_extract.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.onnx_extract.restype = ctypes.c_int
    rc = lib.onnx_extract(str(onnx_path).encode(), str(out_path).encode())
    if rc != 0:
        raise RuntimeError(f"onnx_extract failed with code {rc} for {onnx_path}")
    return read_container(out_path)


def read_container(path: str | Path) -> OnnxGraph:
    """The tensors and nodes of a ``.jtw`` container."""
    data = Path(path).read_bytes()
    if data[:8] != b"JTONNX1\0":
        raise ValueError(f"{path}: not a .jtw container")
    off = 8

    def take(fmt: str) -> int:
        nonlocal off
        v = struct.unpack_from(fmt, data, off)[0]
        off += struct.calcsize(fmt)
        return v

    def text() -> str:
        nonlocal off
        n = take("<I")
        off += n
        return data[off - n : off].decode()

    tensors: dict[str, np.ndarray] = {}
    for _ in range(take("<I")):
        name, dtype, ndims = text(), take("<I"), take("<I")
        dims = [take("<Q") for _ in range(ndims)]
        nbytes = take("<Q")
        raw = data[off : off + nbytes]
        off += nbytes
        tensors[name] = np.frombuffer(raw, dtype=_ONNX_DTYPES.get(dtype, np.float32)).reshape(dims).copy()
    nodes = []
    for _ in range(take("<I")):
        op = text()
        ins = [text() for _ in range(take("<I"))]
        outs = [text() for _ in range(take("<I"))]
        nodes.append((op, ins, outs))
    return OnnxGraph(tensors=tensors, nodes=nodes)


def load_graph(path: str | Path) -> OnnxGraph:
    """The graph of a ``.jtw`` container, or of an ``.onnx`` file through the extractor."""
    path = Path(path)
    return read_container(path) if path.suffix == ".jtw" else extract_onnx(path)


def gemm_chain(graph: OnnxGraph) -> tuple[list, tuple]:
    """([(W (out, in), b (out,)), ...], activation per layer ("" for none))
    of a Gemm/activation chain; a Gemm is taken with transB, out = x W^T + b."""
    layers, acts = [], []
    for op, ins, _ in graph.nodes:
        if op == "Gemm":
            w = graph.tensors[next(i for i in ins if "weight" in i)]
            b = graph.tensors[next(i for i in ins if "bias" in i)]
            layers.append((w, b))
            acts.append("")
        elif op in ACTIVATIONS:
            if not layers:
                raise ValueError(f"activation {op} before any Gemm")
            acts[-1] = op
        elif op not in ("Flatten", "Identity", "Cast"):
            raise NotImplementedError(f"unsupported ONNX op in policy: {op}")
    return layers, tuple(acts)


class MLPPolicy(nn.Module):
    """Feed-forward policy from an ONNX Gemm/activation chain: ``layers[i]``
    (an ``nn.Linear`` holding W (out, in)) then ``activations[i]``."""

    def __init__(self, layers: list, activations: tuple, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.layers = nn.ModuleList()
        for w, b in layers:
            lin = nn.Linear(w.shape[1], w.shape[0], dtype=dtype)
            with torch.no_grad():
                lin.weight.copy_(torch.as_tensor(np.asarray(w), dtype=dtype))
                lin.bias.copy_(torch.as_tensor(np.asarray(b), dtype=dtype))
            lin.requires_grad_(False)
            self.layers.append(lin)
        self.activations = tuple(activations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin, act in zip(self.layers, self.activations):
            x = lin(x)
            if act:
                x = ACTIVATIONS[act](x)
        return x

    @property
    def input_dim(self) -> int:
        return self.layers[0].in_features

    @property
    def output_dim(self) -> int:
        return self.layers[-1].out_features


def mlp_from_onnx(path: str | Path, dtype: torch.dtype = torch.float32, device: Any = "cuda") -> MLPPolicy:
    """An ``MLPPolicy`` in ``dtype`` on ``device`` from a raw ``.onnx``
    (through the extractor) or an extracted ``.jtw`` container."""
    return MLPPolicy(*gemm_chain(load_graph(path)), dtype=dtype).to(resolve_device(device))
