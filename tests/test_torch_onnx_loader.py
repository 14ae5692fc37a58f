"""The port's ONNX loader against the JAX package's, on the CPU: a small ONNX
model encoded here by hand (there is no ``onnx`` package), the extractor
built from ``native/onnx_extract.cpp`` into the port's build directory, and
the MLPs of both packages on the same inputs. The JAX ``extract_onnx`` is
never called: its build rewrites the tracked ``native/libonnx_extract.so``."""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from judo_tpu.utils.onnx_loader import mlp_from_onnx as jax_mlp_from_onnx
from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.policy import SpotPolicy
from judo_tpu_torch.utils import onnx_loader
from judo_tpu_torch.utils.onnx_loader import extract_onnx, mlp_from_onnx, read_container

REPO = Path(__file__).resolve().parents[1]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes or str length-delimited."""
    if isinstance(value, int):
        return _varint(number << 3) + _varint(value)
    data = value.encode() if isinstance(value, str) else value
    return _varint(number << 3 | 2) + _varint(len(data)) + data


def _tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims (1), data_type (2; FLOAT is 1), name (8), raw_data (9)."""
    dims = b"".join(_field(1, d) for d in array.shape)
    return dims + _field(2, 1) + _field(8, name) + _field(9, np.ascontiguousarray(array, "<f4").tobytes())


def _node(op: str, inputs, outputs, trans_b: bool = False) -> bytes:
    """NodeProto: input (1), output (2), name (3), op_type (4), attribute (5)."""
    out = b"".join(_field(1, i) for i in inputs) + b"".join(_field(2, o) for o in outputs)
    out += _field(3, f"{op}_{outputs[0]}") + _field(4, op)
    if trans_b:  # AttributeProto: name (1), i (3), type (20; INT is 2)
        out += _field(5, _field(1, "transB") + _field(3, 1) + _field(20, 2))
    return out


def write_onnx(path: Path, tensors: dict, nodes: list) -> None:
    """A ModelProto: ir_version (field 1) 8 and the graph (field 7) of the initializers and nodes."""
    graph = _field(2, "policy")
    graph += b"".join(_field(1, _node(*n)) for n in nodes)
    graph += b"".join(_field(5, _tensor(k, v)) for k, v in tensors.items())
    path.write_bytes(_field(1, 8) + _field(7, graph))


NODES = [
    ("Gemm", ["obs", "fc1.weight", "fc1.bias"], ["h1"], True),
    ("Elu", ["h1"], ["h2"]),
    ("Gemm", ["h2", "fc2.weight", "fc2.bias"], ["action"], True),
]


@pytest.fixture
def model(tmp_path):
    """A Gemm (transB) -> Elu -> Gemm network, 5 -> 7 -> 3, float32, as .onnx."""
    rng = np.random.default_rng(0)
    tensors = {
        "fc1.weight": rng.standard_normal((7, 5)).astype(np.float32),
        "fc1.bias": rng.standard_normal(7).astype(np.float32),
        "fc2.weight": rng.standard_normal((3, 7)).astype(np.float32),
        "fc2.bias": rng.standard_normal(3).astype(np.float32),
    }
    path = tmp_path / "policy.onnx"
    write_onnx(path, tensors, NODES)
    return path, tensors


def _native_digest() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted((REPO / "native").iterdir())}


def test_extract_onnx_returns_the_written_graph(model, tmp_path):
    """Exactly the tensors and nodes written, in both the returned graph and
    the container on disk; native/ stays byte-for-byte as it was."""
    before = _native_digest()
    path, tensors = model
    graph = extract_onnx(path)
    assert path.with_suffix(".jtw").exists()
    other = extract_onnx(path, tmp_path / "elsewhere.jtw")
    for g in (graph, other, read_container(path.with_suffix(".jtw"))):
        assert list(g.tensors) == list(tensors)
        for k, v in tensors.items():
            assert g.tensors[k].dtype == np.float32
            np.testing.assert_array_equal(g.tensors[k], v)
        assert g.nodes == [(op, ins, outs) for op, ins, outs, *_ in NODES]
    assert _native_digest() == before
    assert onnx_loader.extractor_path().parent.parent == onnx_loader.BUILD_DIR


def test_mlp_from_onnx_matches_jax(model):
    """The port's MLP from the .onnx and from its extracted .jtw against the
    JAX MLP reading that .jtw, float32, to 1e-6."""
    path, _ = model
    ours = mlp_from_onnx(path, torch.float32, "cpu")
    again = mlp_from_onnx(path.with_suffix(".jtw"), torch.float32, "cpu")
    ref = jax_mlp_from_onnx(path.with_suffix(".jtw"), jnp.float32)
    x = np.random.default_rng(1).standard_normal((11, 5)).astype(np.float32)
    out = ours(torch.as_tensor(x)).numpy()
    assert (ours.input_dim, ours.output_dim) == (ref.input_dim, ref.output_dim) == (5, 3)
    assert ours.activations == ref.activations == ("Elu", "")
    np.testing.assert_array_equal(out, again(torch.as_tensor(x)).numpy())
    np.testing.assert_allclose(out, np.asarray(ref(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_mlp_from_onnx_matches_jax_on_the_spot_policy():
    """The vendored Spot locomotion policy, float64, to 1e-12."""
    ours = mlp_from_onnx(sc.SPOT_LOCOMOTION_POLICY_PATH, torch.float64, "cpu")
    ref = jax_mlp_from_onnx(sc.SPOT_LOCOMOTION_POLICY_PATH, jnp.float64)
    x = np.random.default_rng(2).standard_normal((16, 84))
    out = ours(torch.as_tensor(x)).numpy()
    assert out.shape == (16, 12) and ours.layers[0].weight.dtype == torch.float64
    np.testing.assert_allclose(out, np.asarray(ref(jnp.asarray(x))), rtol=0, atol=1e-12)


def test_spot_policy_loads_a_users_onnx(model):
    """SpotPolicy.load takes a user's .onnx (through the extractor) and, by
    default, the package's .jtw; both as float32 parameters."""
    path, tensors = model
    policy = SpotPolicy.load(path, device="cpu")
    assert policy.dims == [5, 7, 3] and policy.activations == ("Elu", "")
    np.testing.assert_array_equal(policy.layers[1].weight.numpy(), tensors["fc2.weight"])
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((4, 5)))
    mlp = mlp_from_onnx(path, torch.float64, "cpu")
    torch.testing.assert_close(policy(x), mlp(x), rtol=0, atol=1e-12)
    default = SpotPolicy.load(device="cpu")
    assert default.dims == [84, 512, 256, 128, 12] and default.layers[0].weight.dtype == torch.float32


def test_entry_points_default_to_the_card(model):
    path, _ = model
    if torch.cuda.is_available():
        assert SpotPolicy.load(path).layers[0].weight.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpotPolicy.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mlp_from_onnx(path)


def test_extractor_failures_raise(model, tmp_path, monkeypatch):
    """A file the extractor cannot read and a source that does not compile
    both raise, the latter with the compiler's output; nothing falls back."""
    with pytest.raises(RuntimeError, match="onnx_extract failed with code 1"):
        extract_onnx(tmp_path / "missing.onnx")
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(b"\x3a\xff\xff\xff\xff\x0f")  # graph field with a length past the end
    with pytest.raises(RuntimeError, match="onnx_extract failed with code 3"):
        extract_onnx(bad)
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(onnx_loader, "EXTRACTOR_SOURCE", broken)
    monkeypatch.setattr(onnx_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the ONNX extractor failed"):
        extract_onnx(model[0])
    with pytest.raises(ValueError, match="not a .jtw container"):
        read_container(broken)
