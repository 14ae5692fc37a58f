"""Simulation backend registry, with the JAX package's keys (so launch configs
carry over): ``mujoco`` and ``mujoco_policy`` (CPU MuJoCo, where it is
installed) and ``judo_tpu`` (the port's own engine, on the card)."""

from judo_tpu_torch.simulation.base import Simulation
from judo_tpu_torch.simulation.jt_simulation import JTSimulation
from judo_tpu_torch.simulation.mj_simulation import MJSimulation
from judo_tpu_torch.simulation.policy_simulation import HostSpotPolicy, PolicySimulation

_backends = {
    "mujoco": MJSimulation,
    "mujoco_policy": PolicySimulation,
    "judo_tpu": JTSimulation,
}


def get_simulation_backend(name: str):
    if name not in _backends:
        raise ValueError(f"Unknown simulation backend '{name}'. Available: {list(_backends)}")
    return _backends[name]


def register_simulation_backend(name: str, cls) -> None:
    _backends[name] = cls


__all__ = [
    "HostSpotPolicy", "JTSimulation", "MJSimulation", "PolicySimulation", "Simulation", "get_simulation_backend",
    "register_simulation_backend",
]
