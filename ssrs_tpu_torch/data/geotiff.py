"""Copy of ``ssrs_tpu/data/geotiff.py``, unchanged apart from imports.

GeoTIFF reading/writing without GDAL.

The reference caches every downloaded terrain layer as GeoTIFF and
validates cached files by bounds containment (ssrs/terrain/terrain.py:81-94,
ssrs/raster.py:147-166). rasterio/GDAL is unavailable here, so pixel
data is decoded by the in-repo TIFF/BigTIFF decoder
(:mod:`ssrs_tpu.data.tiffcore` — tiles/strips, Deflate/LZW/PackBits,
predictors 2/3, multi-band, GDAL nodata, no Pillow bomb limits) and the
georeferencing TIFF tags are parsed directly (ModelPixelScale 33550,
ModelTiepoint 33922, GeoKeyDirectory 34735). Size policy: declared
dimensions are checked against ``SSRS_TIFF_MAX_PIXELS`` (default 2e9)
before allocation — see tiffcore for the rationale. Writing uses
Pillow (single-band float32 strips; read back byte-exactly by
tiffcore, round-trip-tested).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .tiffcore import read_tiff

MODEL_PIXEL_SCALE = 33550
MODEL_TIEPOINT = 33922
GEO_KEY_DIRECTORY = 34735

# GeoKey ids
GT_MODEL_TYPE = 1024
GEOGRAPHIC_TYPE = 2048
PROJECTED_CS_TYPE = 3072


@dataclass
class RasterInfo:
    data: np.ndarray                      # (nrow, ncol), north-up row 0
    bounds: Tuple[float, float, float, float]  # (west, south, east, north)
    crs_code: Optional[str]               # e.g. 'EPSG:4326' when known
    nodata: Optional[float] = None        # GDAL nodata value when tagged
    nbands: int = 1                       # bands in the source file

    @property
    def transform(self):
        """(x_origin, y_origin, dx, dy) with y_origin at the north edge."""
        nrow, ncol = self.data.shape
        dx = (self.bounds[2] - self.bounds[0]) / ncol
        dy = (self.bounds[3] - self.bounds[1]) / nrow
        return self.bounds[0], self.bounds[3], dx, dy


def read_geotiff(fpath: str, band: int = 1,
                 mask_nodata: bool = False) -> RasterInfo:
    """Read one band (1-indexed, rasterio convention) + georeferencing.
    Raises FileNotFoundError like the reference's
    ``check_if_raster_file_exists`` (ssrs/raster.py:163-166).
    ``mask_nodata`` replaces GDAL-tagged nodata cells with NaN."""
    img = read_tiff(fpath)
    data = img.band_masked(band) if mask_nodata else img.band(band)
    tags = {tag: vals for tag, (_, vals) in img.tags.items()}

    scale = tags.get(MODEL_PIXEL_SCALE)
    tiepoint = tags.get(MODEL_TIEPOINT)
    nrow, ncol = data.shape
    if scale is not None and tiepoint is not None:
        dx, dy = float(scale[0]), float(scale[1])
        # tiepoint: (i, j, k, x, y, z) — raster point -> model point
        i, j = float(tiepoint[0]), float(tiepoint[1])
        x0 = float(tiepoint[3]) - i * dx
        y0 = float(tiepoint[4]) + j * dy
        bounds = (x0, y0 - nrow * dy, x0 + ncol * dx, y0)
    else:
        bounds = (0., 0., float(ncol), float(nrow))

    crs_code = None
    geokeys = tags.get(GEO_KEY_DIRECTORY)
    if geokeys is not None:
        keys = np.asarray(geokeys).reshape(-1, 4)
        for key_id, loc, count, value in keys[1:]:
            if key_id == PROJECTED_CS_TYPE and loc == 0:
                crs_code = f'EPSG:{int(value)}'
            elif key_id == GEOGRAPHIC_TYPE and loc == 0 and crs_code is None:
                crs_code = f'EPSG:{int(value)}'

    return RasterInfo(data=np.asarray(data, np.float64), bounds=bounds,
                      crs_code=crs_code, nodata=img.nodata,
                      nbands=img.nbands)


def write_geotiff(fpath: str, data: np.ndarray,
                  bounds: Tuple[float, float, float, float],
                  epsg: int = 4326) -> None:
    """Write a float32 GeoTIFF (north-up) with geo tags readable by
    ``read_geotiff`` and by GDAL."""
    from PIL import Image
    from PIL.TiffImagePlugin import ImageFileDirectory_v2

    data = np.asarray(data, np.float32)
    nrow, ncol = data.shape
    dx = (bounds[2] - bounds[0]) / ncol
    dy = (bounds[3] - bounds[1]) / nrow

    ifd = ImageFileDirectory_v2()
    ifd[MODEL_PIXEL_SCALE] = (dx, dy, 0.0)
    ifd[MODEL_TIEPOINT] = (0.0, 0.0, 0.0, bounds[0], bounds[3], 0.0)
    # GeoKeyDirectory: version 1.1.0, 3 keys
    model_type = 2 if epsg in (4326, 4269) else 1
    keys = [
        (1, 1, 0, 3),
        (GT_MODEL_TYPE, 0, 1, model_type),
        (1025, 0, 1, 1),  # RasterPixelIsArea
        ((GEOGRAPHIC_TYPE if model_type == 2 else PROJECTED_CS_TYPE),
         0, 1, epsg),
    ]
    ifd[GEO_KEY_DIRECTORY] = tuple(v for k in keys for v in k)

    img = Image.fromarray(data, mode='F')
    img.save(fpath, format='TIFF', tiffinfo=ifd)


def get_raster_bounds(fpath: str):
    """Bounds of a GeoTIFF, rounded like the reference
    (ssrs/raster.py:155-160)."""
    info = read_geotiff(fpath)
    return [round(v, 8) for v in info.bounds]


def get_raster_data(fpath: str, band: int = 1,
                    mask_nodata: bool = False) -> np.ndarray:
    """Raster data flipped to lower-left origin (ssrs/raster.py:147-152)."""
    info = read_geotiff(fpath, band=band, mask_nodata=mask_nodata)
    return np.flipud(info.data)
