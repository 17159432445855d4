"""Copy of ``ssrs_tpu/core/grid.py``, unchanged apart from imports.

Grid geometry for a simulation region.

The reference derives the terrain grid inside ``Simulator.__init__``
(ssrs/simulator.py:69-85): grid size from ``region_width_km / resolution``,
projected bounds from the transformed southwest corner plus
``(n-1) * resolution``, and a lower-left-origin row/col convention
(row = northing index, col = easting index). This module captures that
geometry as a standalone value type so the device kernels never touch CRS
machinery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Grid:
    """Regular lower-left-origin grid in a projected CRS.

    Attributes
    ----------
    shape : (nrow, ncol) — row is northing, col is easting; row 0 is the
        southern edge (the reference flips rasters to lower-left origin,
        ssrs/raster.py:49).
    resolution : cell size in meters (same in both directions).
    bounds : (west, south, east, north) in projected CRS meters; east/north
        are the coordinates of the *last grid point* (inclusive), matching
        ``proj_west + (xsize-1)*res`` (ssrs/simulator.py:80-82).
    """

    shape: Tuple[int, int]
    resolution: float
    bounds: Tuple[float, float, float, float] = (0., 0., 0., 0.)

    @classmethod
    def from_region(cls, region_width_km: Tuple[float, float],
                    resolution: float,
                    southwest_xy: Tuple[float, float] = (0., 0.)) -> 'Grid':
        """Build the grid the way the reference does
        (ssrs/simulator.py:71-82): size = round(width_km * 1000 / res)."""
        xsize = int(round(region_width_km[0] * 1000. / resolution))
        ysize = int(round(region_width_km[1] * 1000. / resolution))
        west, south = southwest_xy
        east = west + (xsize - 1) * resolution
        north = south + (ysize - 1) * resolution
        return cls(shape=(ysize, xsize), resolution=float(resolution),
                   bounds=(west, south, east, north))

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def extent(self) -> Tuple[float, float, float, float]:
        """Matplotlib-style (west, east, south, north); see
        ssrs/utils.py:74-85."""
        west, south, east, north = self.bounds
        return (west, east, south, north)

    def xy_grid(self):
        """1-D easting/northing coordinate vectors of the grid points
        (matches ``Simulator.get_terrain_grid``, ssrs/simulator.py:177-185).
        """
        west, south, _, _ = self.bounds
        xgrid = west + self.resolution * np.arange(self.ncol)
        ygrid = south + self.resolution * np.arange(self.nrow)
        return xgrid, ygrid

    def burnin_length(self) -> int:
        """Initial steps during which agents are pushed off the boundary
        (ssrs/movmodel.py:276)."""
        return int(min(self.nrow, self.ncol) / 10)

    def reference_max_moves(self) -> int:
        """The reference's (huge) per-track step cap
        ``(nrow/2)*(ncol/2)`` (ssrs/movmodel.py:277); the while-loop there
        admits a final fractional step, hence the ceil."""
        return int(np.ceil(self.nrow / 2 * self.ncol / 2))
