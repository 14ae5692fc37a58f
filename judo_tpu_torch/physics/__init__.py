"""Lanes physics in PyTorch: model lowering, the step, and the fused rollout
(``judo_tpu_torch.physics.fused_rollout``)."""

from judo_tpu_torch.physics.model import PhysicsModel, load_snapshot, make_state, put_model

__all__ = ["PhysicsModel", "load_snapshot", "make_state", "put_model"]
