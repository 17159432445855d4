"""ssrs_tpu_torch — the PyTorch and CUDA port of ``ssrs_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It mirrors
``ssrs_tpu``'s module layout; the agent step is a hand-written CUDA
kernel (``csrc/fused_step.cu``) built with nvcc at first use. This slice
runs the uniform-mode ``fluidflow`` simulation with the host float64
direct potential solve; README.md and ROADMAP.md say what is ported and
what is not. The package imports torch, numpy and scipy, never JAX.
"""

from .config import Config
from .core import Grid
from .simulator import Simulator

__version__ = '0.1.0'

__all__ = ['Config', 'Grid', 'Simulator']
