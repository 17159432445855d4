"""Terrain derivatives: Horn 3x3 slope/aspect stencils.

The PyTorch counterpart of ``ssrs_tpu/fields/terrain.py`` (reference
semantics: ``compute_slope_degrees`` / ``compute_aspect_degrees``,
ssrs/layers.py:63-128). The reference treats axis 0 of ``z`` as *x* in
its stencil naming ("upper left" = ``z[:-2, 2:]``), so dz_dx is the
gradient along axis 0 and dz_dy along axis 1; border cells are zero.

``compute_slope_richdem_degrees`` and ``compute_aspect_richdem_degrees``
are the same Horn gradients in richdem's raster convention and with its
nodata border (ssrs/layers.py:131-168).

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


def _richdem_gradients(z_mat: torch.Tensor, res: float):
    """Horn gradients in richdem/GDAL's raster convention: x along axis 1
    (columns, "easting"), y along axis 0 with row 0 treated as the TOP of
    the raster; this differs from the reference's own stencil above, which
    treats axis 0 as x. Unit cell size with the elevations scaled by
    ``zscale = 1/res``, as the reference invokes richdem
    (ssrs/layers.py:146-147,166-167)."""
    z = z_mat / res  # richdem's zscale multiplies the elevations
    nw, n_, ne = z[:-2, :-2], z[:-2, 1:-1], z[:-2, 2:]
    w_, e_ = z[1:-1, :-2], z[1:-1, 2:]
    sw, s_, se = z[2:, :-2], z[2:, 1:-1], z[2:, 2:]
    dz_dx = ((ne + 2. * e_ + se) - (nw + 2. * w_ + sw)) / 8.
    dz_dy = ((sw + 2. * s_ + se) - (nw + 2. * n_ + ne)) / 8.
    return dz_dx, dz_dy


def _embed_nodata(interior: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = torch.full_like(like, -9999.)
    out[1:-1, 1:-1] = interior
    return out


def compute_slope_richdem_degrees(z_mat, res: float) -> torch.Tensor:
    """richdem's 'slope_degrees' attribute (ssrs/layers.py:131-148): equal
    to :func:`compute_slope_degrees` in the interior (the gradient
    magnitude does not depend on the axis order); the border carries
    richdem's nodata value -9999 instead of 0."""
    z_mat = _as_f32(z_mat)
    interior = _slope(*_richdem_gradients(z_mat, res))
    return _embed_nodata(torch.nan_to_num(interior), z_mat)


def compute_aspect_richdem_degrees(z_mat, res: float) -> torch.Tensor:
    """richdem's 'aspect' attribute (ssrs/layers.py:151-168): the compass
    bearing of the downslope direction per Horn 1981 as richdem/GDAL
    implement it, not the reference's own aspect formula.

        raw = degrees(atan2(dz_dy, -dz_dx))
        aspect = 90 - raw            (raw in [0, 90])
                 360 - raw + 90      (raw > 90)
                 90 - raw            (raw < 0)

    so 0 = toward row 0's edge, 90 = east, proceeding clockwise. Flat and
    border cells carry the nodata value -9999."""
    z_mat = _as_f32(z_mat)
    dz_dx, dz_dy = _richdem_gradients(z_mat, res)
    raw = torch.rad2deg(torch.atan2(dz_dy, -dz_dx))
    aspect = torch.where(raw < 0., 90. - raw,
                         torch.where(raw > 90., 360. - raw + 90., 90. - raw))
    flat = (dz_dx == 0.) & (dz_dy == 0.)
    interior = torch.where(flat, torch.full_like(aspect, -9999.), aspect)
    return _embed_nodata(interior, z_mat)


def compute_slope_aspect_degrees(z_mat, res: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slope and aspect from one evaluation of the Horn gradients."""
    z_mat = _as_f32(z_mat)
    dz_dx, dz_dy = _horn_gradients(z_mat, res)
    return (_embed(_slope(dz_dx, dz_dy), z_mat),
            _embed(_aspect(dz_dx, dz_dy), z_mat))
