"""ssrs_tpu_torch — the PyTorch and CUDA port of ``ssrs_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It mirrors
``ssrs_tpu``'s module layout; the agent step and the presence histograms
are hand-written CUDA kernels (``csrc/``) built with nvcc at first use,
and the host track builder (``native/``) is C++ built with g++. It runs
uniform mode: the ``fluidflow`` simulation, with the directional
potential from the refined solver on the run's device (or the host
float64 direct solve), and the directed random walk; thermal
realizations and wind-direction sweeps through the multi-case driver;
recorded trajectories (``_tracks.pkl``) up to ``track_pkl_budget``
tracks. README.md and ROADMAP.md say what is ported and what is not. The package imports torch, numpy and scipy, never JAX.
"""

from .config import Config
from .core import Grid
from .simulator import Simulator

__version__ = '0.1.0'

__all__ = ['Config', 'Grid', 'Simulator']
