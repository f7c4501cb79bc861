"""difacto_tpu_torch — the factorization-machine engine on PyTorch and CUDA.

A port of ``difacto_tpu`` to one NVIDIA Hopper card (H100), beside the JAX
package and held against it. Module paths mirror the JAX package's. The
table and aggregation kernels of the train step are written by hand in
CUDA C++ (``csrc/``, bound in ``ops/cuda.py``); each keeps a plain PyTorch
version that runs when the tensors lie on the CPU. This package imports
neither ``jax`` nor ``difacto_tpu``.
"""

__version__ = "0.1.0"

from .config import Config, DataParam, FMParam, LearnerParam, ShardParam  # noqa: F401
