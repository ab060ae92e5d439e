"""PyTorch/CUDA port of Neural Marionette for one NVIDIA H100.

The JAX package ``neural_marionette_tpu`` beside it is the reference; this
package imports nothing of it and no ``jax``. Hand-written CUDA kernels
live in ``csrc/`` and are built by ``kernels.py`` at first use.
"""
from .config import MarionetteConfig, adjust_config, check_supported
from .skeleton import Skeleton, extract_skeleton

__all__ = ["MarionetteConfig", "adjust_config", "check_supported",
           "Skeleton", "extract_skeleton"]
