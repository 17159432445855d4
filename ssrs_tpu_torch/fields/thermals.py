"""Stochastic thermal-updraft field.

The PyTorch counterpart of ``ssrs_tpu/fields/thermals.py``. Reference
semantics (``compute_thermals``, ssrs/layers.py:188-214): for each
interior cell (a 10% border is excluded),
``wtfactor = 1000 + |aspect-180|/180 * 2000`` and a thermal seed is placed
with probability ``P(randint(1, int(wtfactor)) == 5) = 1/(int(wtfactor)-1)``
with lognormal(scale+3, 0.5) magnitude; the seed field is then smoothed
with a Gaussian filter (sigma=4, zero-padded borders).

The reference does this with a per-cell Python double loop; here it is a
vectorized Bernoulli and lognormal draw and a separable Gaussian
convolution on the generator's device. No two generators agree (NumPy's,
JAX's threefry, torch's Philox), so the field is held to the other
packages' statistically.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Discrete Gaussian kernel identical to scipy.ndimage's
    (radius = int(truncate*sigma + 0.5), normalized)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (float(sigma) ** 2) * x ** 2)
    return (phi / phi.sum()).astype(np.float32)


def gaussian_filter(field: torch.Tensor, sigma: float = 4.0,
                    truncate: float = 4.0) -> torch.Tensor:
    """Separable zero-padded Gaussian blur (scipy mode='constant'): one
    convolution along the rows, one along the columns, in full float32.
    cuDNN would otherwise run a float32 convolution in TF32, where the
    JAX package asks for ``Precision.HIGHEST``."""
    kern = torch.from_numpy(gaussian_kernel1d(sigma, truncate)).to(
        field.device)
    ksize = kern.shape[0]
    pad = (ksize - 1) // 2
    x = field.to(torch.float32)[None, None]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = F.conv2d(x, kern.reshape(1, 1, ksize, 1), padding=(pad, 0))
        x = F.conv2d(x, kern.reshape(1, 1, 1, ksize), padding=(0, pad))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return x[0, 0]


def compute_thermals(generator: torch.Generator, aspect,
                     thermal_intensity_scale: float) -> torch.Tensor:
    """Random smoothed thermal field (ssrs/layers.py:188-214), float32 on
    ``generator.device``.

    ``generator`` replaces the reference's global NumPy RNG state. The
    draw order is fixed, so that a seed reproduces its field: first one
    uniform per cell (the Bernoulli seeds), then one normal per cell (the
    lognormal magnitudes), each over the whole ``aspect`` shape.
    """
    device = generator.device
    aspect = torch.as_tensor(aspect).to(device=device, dtype=torch.float32)
    ysize, xsize = aspect.shape
    border_y = int(0.1 * ysize)
    border_x = int(0.1 * xsize)

    # P(randint(1, int(wtfactor)) == 5) = 1 / (int(wtfactor) - 1)
    wtfactor = torch.floor(1000. + (torch.abs(aspect - 180.) / 180.) * 2000.)
    prob = 1. / (wtfactor - 1.)

    seeds = torch.rand(aspect.shape, generator=generator,
                       dtype=torch.float32, device=device) < prob
    # lognormal(mean=m, sigma=s) == exp(m) * exp(s * normal)
    normal = torch.randn(aspect.shape, generator=generator,
                         dtype=torch.float32, device=device)
    magnitude = torch.exp(0.5 * normal) * math.exp(
        thermal_intensity_scale + 3.)

    rows = torch.arange(ysize, device=device)[:, None]
    cols = torch.arange(xsize, device=device)[None, :]
    interior = ((rows >= border_y) & (rows < ysize - border_y) &
                (cols >= border_x) & (cols < xsize - border_x))

    wt_init = torch.where(seeds & interior, magnitude,
                          torch.zeros_like(magnitude))
    return gaussian_filter(wt_init, sigma=4.0)
