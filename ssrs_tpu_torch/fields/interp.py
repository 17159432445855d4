"""Scattered sites to the grid: SciPy ``griddata``'s interpolation as a
plan built once and applied on the run's device.

``griddata(method='linear')`` triangulates its sites (Qhull's Delaunay)
and locates every grid point in the triangulation on each call, and the
WTK interpolation called it with a ``'nearest'`` call beside it for the
cells outside the sites' hull. For one set of sites and one grid all of
that is the same from call to call; only the sites' values change. An
:class:`InterpPlan` does it once, with the objects ``griddata`` uses
inside (``Delaunay`` with its default options, ``find_simplex``,
``cKDTree``), and keeps each cell's three sites and float64 barycentric
weights (Qhull's ``transform``, in ``griddata``'s order) on the device;
a cell outside the hull keeps its nearest site with the weights
``(1, 0, 0)``. Applying it is one gather and a weighted sum in float64,
``griddata``'s own sum in its own order.

``'cubic'`` (Clough-Tocher, whose gradients are estimated iteratively
from the values) stays on ``griddata``; only its cells outside the hull
are answered from the plan's tree. :func:`speed_and_direction`
recomposes interpolated wind components on the same device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def speed_and_direction(east: torch.Tensor, north: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speed and the direction in degrees, in [0, 360), of a wind of
    components ``east`` = speed sin(direction) and ``north`` = speed
    cos(direction), in their dtype on their device
    (ssrs/simulator.py:778-792: ``hypot``, ``arctan2``, ``mod 2 pi``,
    ``degrees``)."""
    dirn = torch.remainder(torch.atan2(east, north) + 2 * np.pi, 2 * np.pi)
    return torch.hypot(east, north), torch.rad2deg(dirn)


class InterpPlan:
    """The interpolation of the values at ``points`` (S sites, (S, 2)
    float64) onto the grid of ``xgrid`` x ``ygrid`` (the cells in
    ``np.meshgrid(xgrid, ygrid)``'s order) by ``method``, as
    ``np.where(isnan(griddata(method)), griddata('nearest'), ...)``
    computes it: the nearest site where ``method`` leaves a cell NaN
    (outside the sites' hull) or cannot triangulate the sites at all (too
    few, or on one line). A method other than ``'linear'`` and
    ``'cubic'`` is the nearest site at every cell, as ``griddata``'s
    error for an unknown method left it."""

    def __init__(self, points, xgrid, ygrid, method: str, device) -> None:
        from scipy.spatial import cKDTree
        self.points = np.array(points, dtype=np.float64)
        self.xgrid = np.array(xgrid, dtype=np.float64)
        self.ygrid = np.array(ygrid, dtype=np.float64)
        self.method = method
        self.device = torch.device(device)
        self.tree = cKDTree(self.points)
        self.vertices = self.weights = None
        if method != 'cubic':
            self._locate()

    def fits(self, points, xgrid, ygrid, method: str) -> bool:
        """Whether the plan serves these sites, grid and method."""
        return (method == self.method
                and np.array_equal(points, self.points)
                and np.array_equal(xgrid, self.xgrid)
                and np.array_equal(ygrid, self.ygrid))

    @property
    def shape(self):
        return len(self.ygrid), len(self.xgrid)

    def _cell_points(self, cells=None) -> np.ndarray:
        """The (x, y) of the grid's cells (all of them, in order, by
        default), as ``griddata`` is given them."""
        if cells is None:
            cells = np.arange(self.shape[0] * self.shape[1])
        rows, cols = np.divmod(cells, self.shape[1])
        return np.column_stack([self.xgrid[cols], self.ygrid[rows]])

    def _locate(self) -> None:
        """Each cell's sites and weights: the Delaunay simplex that holds it
        (``'linear'``) or its nearest site."""
        from scipy.spatial import Delaunay, QhullError
        xi = self._cell_points()
        ncell = xi.shape[0]
        simplex, tri = np.full(ncell, -1), None
        if self.method == 'linear':
            try:
                tri = Delaunay(self.points)
            except (QhullError, ValueError):
                pass            # no triangulation: the nearest site
            else:
                simplex = tri.find_simplex(xi)
        inside = simplex >= 0
        vertices = np.empty((ncell, 3), dtype=np.int64)
        weights = np.zeros((ncell, 3), dtype=np.float64)
        if inside.any():
            # Qhull's barycentric coordinates, summed as it sums them
            trans = tri.transform[simplex[inside]]
            d = xi[inside] - trans[:, 2]
            c0 = trans[:, 0, 0] * d[:, 0] + trans[:, 0, 1] * d[:, 1]
            c1 = trans[:, 1, 0] * d[:, 0] + trans[:, 1, 1] * d[:, 1]
            vertices[inside] = tri.simplices[simplex[inside]]
            weights[inside] = np.column_stack([c0, c1, 1. - c0 - c1])
        outside = ~inside
        if outside.any():
            vertices[outside] = self.tree.query(xi[outside])[1][:, None]
            weights[outside, 0] = 1.
        self.vertices = torch.from_numpy(vertices).to(self.device)
        self.weights = torch.from_numpy(weights).to(self.device)

    def __call__(self, values) -> torch.Tensor:
        """The grid's values, float64 on the plan's device: (nrow, ncol)
        for values of shape (S,), (nrow, ncol, k) for (S, k)."""
        values = np.asarray(values, dtype=np.float64)
        cols = values.reshape(values.shape[0], -1)
        v = torch.from_numpy(cols).to(self.device)
        if self.method == 'cubic':
            out = torch.from_numpy(self._cubic(cols)).to(self.device)
            self._nearest_at_nans(out, v)
        else:
            part = v[self.vertices] * self.weights[..., None]
            out = part[:, 0] + part[:, 1] + part[:, 2]
            if not np.isfinite(cols).all():
                # NaN where a site's value is: griddata's caller took the
                # nearest site's value there
                self._nearest_at_nans(out, v)
        return out.reshape(self.shape + values.shape[1:])

    def _cubic(self, cols: np.ndarray) -> np.ndarray:
        """``griddata(method='cubic')`` at every cell; all NaN where the
        sites cannot be triangulated."""
        from scipy.interpolate import griddata
        from scipy.spatial import QhullError
        try:
            return griddata(self.points, cols, self._cell_points(),
                            method='cubic')
        except (QhullError, ValueError):
            return np.full((self.shape[0] * self.shape[1], cols.shape[1]),
                           np.nan)

    def _nearest_at_nans(self, out: torch.Tensor, v: torch.Tensor) -> None:
        """The nearest site's value in place of each NaN of ``out``."""
        bad = torch.isnan(out)
        cells = bad.any(dim=1).nonzero()[:, 0]
        if cells.numel() == 0:
            return
        near = self.tree.query(self._cell_points(cells.cpu().numpy()))[1]
        near = v[torch.from_numpy(near).to(self.device)]
        out[cells] = torch.where(bad[cells], near, out[cells])
