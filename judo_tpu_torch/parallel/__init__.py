from judo_tpu_torch.parallel.mesh import (
    HOST_AXIS,
    ROLLOUT_AXIS,
    RolloutMesh,
    initialize_distributed,
    make_rollout_mesh,
    replicated,
    resolve_mesh,
    rollout_sharding,
)

__all__ = [
    "HOST_AXIS",
    "ROLLOUT_AXIS",
    "RolloutMesh",
    "initialize_distributed",
    "make_rollout_mesh",
    "replicated",
    "resolve_mesh",
    "rollout_sharding",
]
