"""How the planning solve runs its rollouts over the shards of a mesh: each
optimizer iteration cuts the rollout inputs (the controls, the start state
and the carried warm start or policy output) into one contiguous block per
shard of this process (``mesh.rollout_sharding``), launches the rollout
kernel once per shard on the shard's device and a CUDA stream of its own
(``launch_shards``), copies each shard's outputs into its columns of
batch-last buffers on the lead device and gathers every process's buffers
(``join_shards``), and hands the solve the whole batch's batch-first views
(``batch_first``).

``run_rollouts`` does all of it at once: the solve's rollouts when it runs
eagerly (on the CPU, and in a solve graph's warm-up). A solve graph captured
on the card cuts its capture at the rollouts and runs the same steps between
its graphs' replays (``controller/solve_graph.py:SolveCapture``), with the
same helpers.

The joined outputs have the layout the kernel wrappers return (batch-first
views of batch-last buffers), so the rewards reduce them in the order of one
launch on the whole batch, and the sharded solve equals the unsharded one
bitwise.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from judo_tpu_torch.parallel.mesh import all_gather_tensor, process_group, ranks_joined, rollout_sharding


def shard_blocks(ctrl, n: int) -> list[tuple[torch.device, slice]]:
    """(device, rows) of each of this process's shards of ``ctrl``'s mesh for
    a batch of ``n``; ``ctrl.last_shards`` records (device, batch) of each."""
    blocks = rollout_sharding(ctrl.mesh).blocks(n)
    ctrl.last_shards = [(str(d), rows.stop - rows.start) for d, rows in blocks]
    return blocks


def launch_shards(ctrl, launch: Callable, shards: list) -> list:
    """``launch(ctrl, *inputs)`` on each (device, inputs) shard, its inputs
    copied to its device: on the card each on a CUDA stream of its own
    (``ctrl.shard_stream``) that waits for the current streams of its device
    and of its inputs' and that its device's current stream then waits for,
    so the shards overlap (also inside a graph capture, where the streams
    fork from the capturing one and join back). Each shard's stream waits
    before it allocates, so no block is reused early."""
    if not any(d.type == "cuda" for d, _ in shards):
        return [launch(ctrl, *(x.to(d) for x in ins)) for d, ins in shards]
    outs, joins = [], []
    for i, (d, ins) in enumerate(shards):
        current = torch.cuda.current_stream(d)
        stream = ctrl.shard_stream(i, d)
        for src in dict.fromkeys([d, *(x.device for x in ins)]):
            stream.wait_stream(torch.cuda.current_stream(src))
        with torch.cuda.stream(stream):
            outs.append(launch(ctrl, *(x.to(d, non_blocking=True) for x in ins)))
        joins.append((current, stream))
    for current, stream in joins:
        current.wait_stream(stream)
    return outs


def join_buffers(lead: torch.device, outs: list) -> tuple[list, list | None]:
    """(this process's batch-last buffers on ``lead`` for the shards'
    batch-last ``outs``, one column block per shard; the buffers every
    process's are gathered into under a process group, else None)."""
    local = [torch.empty((*y.shape[:-1], y.shape[-1] * len(outs)), dtype=y.dtype, device=lead) for y in outs[0]]
    world, _ = process_group()
    if world == 1:
        return local, None
    return local, [torch.empty((world * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=lead) for x in local]


def join_shards(lead: torch.device, outs: list, streams: list, local: list, full: list | None) -> None:
    """Each shard's batch-last outputs into its columns of ``local``: copied
    on the shard's stream where ``streams`` names one (the lead's current
    stream then waits for it), else on the current stream; then every
    process's ``local`` gathered into ``full``."""
    b = local[0].shape[-1] // len(outs)
    for i, (stream, shard) in enumerate(zip(streams, outs)):
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            for dst, src in zip(local, shard):
                dst[..., i * b : (i + 1) * b].copy_(src, non_blocking=True)
        if stream is not None:
            torch.cuda.current_stream(lead).wait_stream(stream)
    for f, x in zip(full or (), local):
        all_gather_tensor(f, x)


def batch_first(local: list, full: list | None) -> tuple:
    """The whole batch's batch-first views of the joined buffers: ``full``'s,
    the ranks' blocks in rank order, under a process group, else ``local``'s."""
    if full is None:
        return tuple(x.movedim(-1, 0) for x in local)
    world, _ = process_group()
    return tuple(ranks_joined(f, world).movedim(-1, 0) for f in full)


def run_rollouts(ctrl, launch: Callable, inputs: tuple) -> tuple:
    """``launch(ctrl, *inputs)`` on the batch-first ``inputs``; with a mesh,
    once per shard of this process on the shard's block of every input, the
    outputs joined on the lead device and gathered from every process."""
    if ctrl.mesh is None:
        return launch(ctrl, *inputs)
    blocks = shard_blocks(ctrl, inputs[0].shape[0])
    outs = launch_shards(ctrl, launch, [(d, [x[rows] for x in inputs]) for d, rows in blocks])
    outs = [[y.movedim(0, -1) for y in shard] for shard in outs]
    local, full = join_buffers(ctrl.device, outs)
    join_shards(ctrl.device, outs, [None] * len(outs), local, full)
    return batch_first(local, full)
