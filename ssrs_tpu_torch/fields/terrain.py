"""Terrain derivatives: Horn 3x3 slope/aspect stencils.

The PyTorch counterpart of ``ssrs_tpu/fields/terrain.py`` (reference
semantics: ``compute_slope_degrees`` / ``compute_aspect_degrees``,
ssrs/layers.py:63-128). The reference treats axis 0 of ``z`` as *x* in
its stencil naming ("upper left" = ``z[:-2, 2:]``), so dz_dx is the
gradient along axis 0 and dz_dy along axis 1; border cells are zero.

Inputs are computed in float32 on the device they lie on, as the JAX
package computes them with 64-bit types off.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _as_f32(z_mat) -> torch.Tensor:
    return torch.as_tensor(z_mat).to(torch.float32)


def _horn_gradients(z_mat: torch.Tensor, res: float):
    """dz_dx, dz_dy on the interior via the Horn stencil
    (ssrs/layers.py:80-90). Returns tensors of shape (nrow-2, ncol-2)."""
    z_1 = z_mat[:-2, 2:]    # "upper left"
    z_2 = z_mat[1:-1, 2:]   # "upper middle"
    z_3 = z_mat[2:, 2:]     # "upper right"
    z_4 = z_mat[:-2, 1:-1]  # "center left"
    z_6 = z_mat[2:, 1:-1]   # "center right"
    z_7 = z_mat[:-2, :-2]   # "lower left"
    z_8 = z_mat[1:-1, :-2]  # "lower middle"
    z_9 = z_mat[2:, :-2]    # "lower right"
    dz_dx = ((z_3 + 2. * z_6 + z_9) - (z_1 + 2. * z_4 + z_7)) / (8. * res)
    dz_dy = ((z_1 + 2. * z_2 + z_3) - (z_7 + 2. * z_8 + z_9)) / (8. * res)
    return dz_dx, dz_dy


def _embed(interior: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(like)
    out[1:-1, 1:-1] = interior
    return torch.nan_to_num(out)


def _slope(dz_dx: torch.Tensor, dz_dy: torch.Tensor) -> torch.Tensor:
    rise_run = torch.sqrt(dz_dx * dz_dx + dz_dy * dz_dy)
    return torch.rad2deg(torch.arctan(rise_run))


def _aspect(dz_dx: torch.Tensor, dz_dy: torch.Tensor) -> torch.Tensor:
    """aspect = 180 - atan(dy/dx) + 90*sign(dx), with a zero dz_dx
    replaced by 1e-10 before the ratio (ssrs/layers.py:96-128)."""
    dz_dx = torch.where(dz_dx == 0., 1e-10, dz_dx)
    angle = torch.rad2deg(torch.arctan(dz_dy / dz_dx))
    return 180. - angle + 90. * dz_dx / torch.abs(dz_dx)


def compute_slope_degrees(z_mat, res: float) -> torch.Tensor:
    """Terrain slope (degrees) via the Horn stencil; border cells are 0
    (ssrs/layers.py:63-93)."""
    z_mat = _as_f32(z_mat)
    return _embed(_slope(*_horn_gradients(z_mat, res)), z_mat)


def compute_aspect_degrees(z_mat, res: float) -> torch.Tensor:
    """Terrain aspect (degrees) via the Horn stencil; border cells are 0
    (ssrs/layers.py:96-128)."""
    z_mat = _as_f32(z_mat)
    return _embed(_aspect(*_horn_gradients(z_mat, res)), z_mat)


def compute_slope_aspect_degrees(z_mat, res: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slope and aspect from one evaluation of the Horn gradients."""
    z_mat = _as_f32(z_mat)
    dz_dx, dz_dy = _horn_gradients(z_mat, res)
    return (_embed(_slope(dz_dx, dz_dy), z_mat),
            _embed(_aspect(dz_dx, dz_dy), z_mat))
