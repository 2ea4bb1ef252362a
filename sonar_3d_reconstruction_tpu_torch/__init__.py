"""PyTorch + CUDA port of ``sonar_3d_reconstruction_tpu``.

Probabilistic 3D seabed reconstruction from multibeam imaging sonar on an
NVIDIA GPU.  The package mirrors the JAX package's layout (``geometry``,
``ops/``, ``grid/``, ``pipeline``); ``kernels/`` holds the Python wrappers
of the hand-written CUDA kernels in ``csrc/``.  It imports torch and numpy,
never jax.  Entry point: ``pipeline.map_ping_sequence``.
"""

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: F401

__version__ = "0.1.0"
