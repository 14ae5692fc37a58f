"""Data parallelism over the rollout batch on several GPUs (counterpart of
``judo_tpu/parallel/mesh.py``).

The planner's only parallel axis is the candidate-rollout batch. A
``RolloutMesh`` lays that batch over devices: the solve cuts its rollout
inputs into one contiguous block per device, in the mesh's flattened
(hosts-major) order, runs the rollout kernel once per block on the block's
device, and gathers the outputs back to the lead device, where the rewards,
the optimizer update and the traces run on the whole batch
(``controller/controller.py``).

- 1 GPU: no mesh (``mesh=None``).
- 1 host, k GPUs: ``make_rollout_mesh()``, a 1-D ``("rollouts",)`` mesh.
- N hosts (one process each): ``initialize_distributed()`` first, then
  ``make_rollout_mesh(hybrid=True)``, a ``("hosts", "rollouts")`` mesh whose
  host axis is outermost. Each process runs the rollouts of its own row and
  the rows are gathered with ``torch.distributed``.

A ``devices`` list may name one device more than once (``["cuda:0"] * 2``,
``["cpu"] * 8``): each entry is a shard of its own on that device.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

ROLLOUT_AXIS = "rollouts"
HOST_AXIS = "hosts"


def process_group() -> tuple[int, int]:
    """(world size, rank) of the default process group, or (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def broadcast_from_rank0(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` on every process of the default group."""
    import torch.distributed as dist

    dist.broadcast(x, src=0)
    return x


def all_gather_tensor(out: torch.Tensor, x: torch.Tensor) -> None:
    """Every process's ``x`` into ``out``, one after another along dim 0, in
    rank order (``all_gather_single``; ``all_gather_into_tensor`` in torch
    releases before 2.13, which lack it)."""
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x)


def ranks_joined(full: torch.Tensor, world: int) -> torch.Tensor:
    """``full``, the ranks' batch-last tensors one after another along dim 0
    (as ``all_gather_tensor`` leaves them), joined along the batch (the last
    dim) in rank order."""
    local = (full.shape[0] // world, *full.shape[1:])
    return full.view(world, *local).movedim(0, -2).reshape(*local[:-1], world * local[-1])


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Start the default ``torch.distributed`` process group for a mesh over
    several hosts, one process per host: NCCL when CUDA is visible, gloo
    otherwise, at ``tcp://{coordinator_address}``.

    The arguments default to torch's own environment variables, which
    ``torchrun`` sets: ``MASTER_ADDR`` and ``MASTER_PORT`` (the address,
    ``host:port``), ``WORLD_SIZE`` (the processes) and ``RANK`` (this one).
    With none of them configured this does nothing (a single host). A second
    call, once the group exists, does nothing; any other failure raises.
    """
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return
    if num_processes is not None and coordinator_address is None:
        raise ValueError(
            "initialize_distributed: num_processes given without a coordinator_address (argument or "
            "MASTER_ADDR env)."
        )
    if num_processes is None or process_id is None:
        raise ValueError(
            f"initialize_distributed: coordinator_address {coordinator_address!r} given without num_processes and "
            "process_id (arguments or WORLD_SIZE and RANK env)."
        )
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


class RolloutMesh:
    """Devices over the rollout batch, as ``jax.sharding.Mesh`` holds them:
    ``devices``, a numpy object array of ``torch.device`` shaped ``(n,)`` or
    ``(hosts, local)``; ``axis_names``; ``shape``, each axis's size.

    With a process group of W > 1 processes, the flattened devices fall into
    W equal rows, one per rank, and a process runs the shards of its own row
    (for a hybrid mesh over W hosts, row r is host r)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]) -> None:
        if devices.ndim != len(axis_names) or devices.size == 0:
            raise ValueError(f"a mesh of devices shaped {devices.shape} cannot have axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_devices(self) -> list[torch.device]:
        """This process's row of the flattened devices, one entry per shard."""
        world, rank = process_group()
        flat = list(self.devices.flat)
        if len(flat) % world:
            raise ValueError(f"a mesh of {len(flat)} devices does not split into rows for {world} processes")
        per = len(flat) // world
        return flat[rank * per : (rank + 1) * per]

    @property
    def lead(self) -> torch.device:
        """The first device of this process's row: where the solve runs
        everything but the rollouts."""
        return self.local_devices()[0]

    def key(self) -> tuple:
        """The devices (flattened) and the shape, as a hashable value."""
        return tuple(str(d) for d in self.devices.flat), tuple(self.devices.shape), self.axis_names

    def __repr__(self) -> str:
        return f"RolloutMesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device(d: Any) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``cuda`` names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


def same_device(a: Any, b: Any) -> bool:
    return _device(a) == _device(b)


def _default_devices() -> list[torch.device]:
    """Every process's visible CUDA devices, process-major (the CPU where
    no GPU is visible), as ``jax.devices()`` lists them."""
    world, _ = process_group()
    local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or [torch.device("cpu")]
    return local * world


def make_rollout_mesh(
    n_devices: int | None = None,
    devices=None,
    hybrid: bool = False,
    devices_per_host: int | None = None,
) -> RolloutMesh:
    """Mesh over the rollout-batch axis.

    ``devices`` defaults to the visible CUDA devices (``cuda:0`` ...
    ``cuda:k-1``; of every process, process-major, under a process group);
    ``n_devices`` takes the first n. ``hybrid=False``: a 1-D ``(rollouts,)``
    mesh. ``hybrid=True``: a ``(hosts, rollouts)`` mesh, the host axis
    outermost, ``devices_per_host`` defaulting to this process's visible
    CUDA devices; the devices must tile into hosts."""
    devices = _default_devices() if devices is None else [_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    if not hybrid:
        return RolloutMesh(arr, (ROLLOUT_AXIS,))
    local = devices_per_host or max(torch.cuda.device_count(), 1)
    n_hosts = len(devices) // local
    if n_hosts * local != len(devices):
        raise ValueError(f"{len(devices)} devices do not tile into hosts of {local}")
    return RolloutMesh(arr.reshape(n_hosts, local), (HOST_AXIS, ROLLOUT_AXIS))


def resolve_mesh(spec) -> RolloutMesh | None:
    """A user's mesh spec as a mesh (the CLI's and the nodes' entry point).

    - ``None``, ``"none"``, ``""``: no mesh (one device).
    - ``"auto"``: a 1-D mesh over every visible CUDA device, or None where
      fewer than two are visible (one card, or none).
    - ``"hybrid"``: ``initialize_distributed()``, then the (hosts,
      devices per host) mesh.
    - a ``RolloutMesh``: passed through.
    """
    if spec is None or spec in ("none", ""):
        return None
    if isinstance(spec, RolloutMesh):
        return spec
    if spec == "auto":
        return make_rollout_mesh() if torch.cuda.is_available() and len(_default_devices()) > 1 else None
    if spec == "hybrid":
        initialize_distributed()
        return make_rollout_mesh(hybrid=True)
    raise ValueError(f"unknown mesh spec {spec!r} (expected none|auto|hybrid or a Mesh)")


class Sharding:
    """How a batch-first tensor lies on a mesh: ``spec`` reads as the JAX
    ``PartitionSpec`` (``(axes...,)``: dim 0 split over those axes; ``()``:
    replicated). ``split`` gives this process's shards, each on its device;
    ``gather`` puts shards back together on one device."""

    def __init__(self, mesh: RolloutMesh, spec: tuple) -> None:
        self.mesh = mesh
        self.spec = spec

    def blocks(self, n: int) -> list[tuple[torch.device, slice]]:
        """(device, rows) of each of this process's shards of a batch of
        ``n``: contiguous equal blocks in the mesh's flattened order (for a
        replicated tensor, every row on every device)."""
        local = self.mesh.local_devices()
        if not self.spec:
            return [(d, slice(0, n)) for d in local]
        size = self.mesh.devices.size
        if n % size:
            raise ValueError(f"a batch of {n} does not split over the {size}-device mesh")
        b = n // size
        first = process_group()[1] * len(local)  # this process's row
        return [(d, slice((first + i) * b, (first + i + 1) * b)) for i, d in enumerate(local)]

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [x[rows].to(d, non_blocking=True) for d, rows in self.blocks(x.shape[0])]

    def gather(self, parts: list[torch.Tensor], device: Any) -> torch.Tensor:
        if not self.spec:
            return parts[0].to(device)
        return torch.cat([p.to(device, non_blocking=True) for p in parts])


def rollout_sharding(mesh: RolloutMesh) -> Sharding:
    """(R, ...) tensors split over every axis of the mesh, hosts outermost."""
    return Sharding(mesh, tuple(mesh.axis_names))


def replicated(mesh: RolloutMesh) -> Sharding:
    return Sharding(mesh, ())
