"""Copy of ``ssrs_tpu/data/raster.py``, unchanged apart from imports.

Raster reprojection onto the run grid.

Reference semantics (``get_raster_in_projected_crs``,
ssrs/raster.py:12-49): reproject a source GeoTIFF (usually geographic
EPSG:4326 from 3DEP) onto the run's projected grid with bilinear
resampling, then flip to lower-left origin. GDAL is unavailable, so the
warp is done directly: build the output pixel-center lattice, transform it
into the source CRS with the pure-Python CRS engine, and bilinearly sample
the source raster (scipy map_coordinates). This matches rasterio's
``reproject`` to interpolation tolerance for north-up affine sources — the
only kind SSRS produces.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from .crs import get_crs, transform_coordinates
from .geotiff import read_geotiff

# re-exported for API parity with the reference module
from .crs import transform_bounds, get_utm_string  # noqa: F401
from .geotiff import get_raster_bounds, get_raster_data  # noqa: F401


def get_raster_in_projected_crs(
        fpath: str,
        proj_bounds: Tuple[float, float, float, float],
        proj_gridsize: Tuple[int, int],
        proj_res: Union[float, Tuple[float, float]],
        proj_crs_string: str) -> np.ndarray:
    """Raster data from ``fpath`` on the projected run grid, lower-left
    origin (ssrs/raster.py:12-49)."""
    proj_crs = get_crs(proj_crs_string)
    if not proj_crs.is_projected:
        raise AssertionError(f'{proj_crs_string} is not a projected crs!')

    src = read_geotiff(fpath)
    src_crs_string = src.crs_code or 'EPSG:4326'

    dx = proj_res if isinstance(proj_res, (int, float)) else proj_res[0]
    dy = proj_res if isinstance(proj_res, (int, float)) else proj_res[1]
    nrow, ncol = proj_gridsize

    # output pixel centers, row 0 at the north edge (rasterio convention;
    # flipped to lower-left at the end like ssrs/raster.py:49)
    west, north = proj_bounds[0], proj_bounds[3]
    xs = west + (np.arange(ncol) + 0.5) * dx
    ys = north - (np.arange(nrow) + 0.5) * dy
    xg, yg = np.meshgrid(xs, ys)

    sx, sy = transform_coordinates(proj_crs_string, src_crs_string, xg, yg)

    x0, y0, sdx, sdy = src.transform
    cols = (np.asarray(sx) - x0) / sdx - 0.5
    rows = (y0 - np.asarray(sy)) / sdy - 0.5

    from scipy.ndimage import map_coordinates
    out = map_coordinates(src.data, [rows, cols], order=1, mode='nearest')
    return np.flipud(out.reshape(proj_gridsize))


def resample_to_grid(data: np.ndarray,
                     src_bounds: Tuple[float, float, float, float],
                     src_crs: str,
                     proj_bounds: Tuple[float, float, float, float],
                     proj_gridsize: Tuple[int, int],
                     proj_res: float,
                     proj_crs: str) -> np.ndarray:
    """Same warp for an in-memory north-up array (used by the synthetic
    terrain source and fixtures)."""
    nrow, ncol = proj_gridsize
    west, north = proj_bounds[0], proj_bounds[3]
    xs = west + (np.arange(ncol) + 0.5) * proj_res
    ys = north - (np.arange(nrow) + 0.5) * proj_res
    xg, yg = np.meshgrid(xs, ys)
    sx, sy = transform_coordinates(proj_crs, src_crs, xg, yg)
    snrow, sncol = data.shape
    sdx = (src_bounds[2] - src_bounds[0]) / sncol
    sdy = (src_bounds[3] - src_bounds[1]) / snrow
    cols = (np.asarray(sx) - src_bounds[0]) / sdx - 0.5
    rows = (src_bounds[3] - np.asarray(sy)) / sdy - 0.5
    from scipy.ndimage import map_coordinates
    out = map_coordinates(np.asarray(data, np.float64), [rows, cols],
                          order=1, mode='nearest')
    return np.flipud(out.reshape(proj_gridsize))
