"""ssrs_tpu_torch — the PyTorch and CUDA port of ``ssrs_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It mirrors
``ssrs_tpu``'s module layout; the agent step and the presence histograms
are hand-written CUDA kernels (``csrc/``) built with nvcc at first use,
and the host track builder (``native/``) is C++ built with g++. It runs
uniform, snapshot and seasonal mode: the ``fluidflow`` simulation, with
the directional potential from the refined solver on the run's device
(or the host float64 direct solve), and the directed random walk;
thermal realizations, wind-direction sweeps and WindToolKit cases
through the multi-case driver; recorded trajectories (``_tracks.pkl``)
up to ``track_pkl_budget`` tracks; the terrain, turbine and WindToolKit
clients (``data/``) and turbine presence scores; the reference's figures
(``plotting.py``) and the command line, ``python -m ssrs_tpu_torch run
CONFIG.json`` (``__main__.py``); on several devices, agents sharded over
a mesh and fields by rows (``parallel/``). README.md and ROADMAP.md say what is
ported and what is not. The package imports torch, numpy and scipy,
never JAX or pandas; ``requests``, ``h5py`` and ``h5pyd`` only where a
data source that needs them is used, and matplotlib only where a figure
is drawn.
"""

from .config import Config
from .core import Grid
from .simulator import Simulator

__version__ = '0.1.0'

__all__ = ['Config', 'Grid', 'Simulator']
