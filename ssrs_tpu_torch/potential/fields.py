"""Synthetic conductivity fields for checking the potential solvers.

``conductivity_hard`` is a copy of ``tests/test_potential.py``'s
``_conductivity_hard`` (``tests/test_torch_potential.py`` holds the two
equal), so that the card's checks, which run without JAX, solve the same
field. Numpy only.
"""

from __future__ import annotations

import numpy as np


def conductivity_hard(shape, seed=0) -> np.ndarray:
    """Thresholded-updraft-like field: zero plateaus and smooth lobes."""
    rng = np.random.default_rng(seed)
    nrow, ncol = shape
    y = np.linspace(0, 3 * np.pi, nrow)[:, None]
    x = np.linspace(0, 4 * np.pi, ncol)[None, :]
    w = 1.5 * np.abs(np.sin(x) * np.cos(0.8 * y)) + 0.1 * rng.random(shape)
    w[w < 0.6] = 0.0
    return w.astype(np.float32)


def speckle(rng: np.random.Generator, shape, thresh) -> np.ndarray:
    """Uniform noise with the cells below ``thresh`` zeroed: many small
    floating islands."""
    w = rng.random(shape).astype(np.float32)
    w[w < thresh] = 0.0
    return w
