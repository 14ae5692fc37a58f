"""judo_tpu_torch: the PyTorch and CUDA port of judo_tpu.

Sampling-based MPC on one NVIDIA GPU. The rollout physics runs as one
hand-written CUDA kernel per plan (``physics/fused_rollout.py``); everything
around it is plain PyTorch. The JAX package ``judo_tpu`` is the reference this
port is held against; this package never imports JAX.
"""

from pathlib import Path

PACKAGE_ROOT = Path(__file__).parent

__version__ = "0.1.0"

__all__ = ["PACKAGE_ROOT", "__version__"]
