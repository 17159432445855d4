"""Copy of ``ssrs_tpu/data/srtm.py``, unchanged apart from imports.

SRTM fallback elevation source.

The reference shells out to the ``elevation`` package (GDAL CLI pipeline,
ssrs/terrain/srtm.py). Neither is available here; SRTM1 tiles are fetched
directly from the public AWS mirror (s3://elevation-tiles-prod skadi
.hgt.gz tiles), decoded, mosaicked and clipped — no GDAL needed.
"""

from __future__ import annotations

import gzip
import math
import os
from typing import Tuple

import numpy as np

from .geotiff import write_geotiff


class SRTMError(Exception):
    pass


class SRTM:
    """SRTM elevation downloader (API mirrors ssrs/terrain/srtm.py)."""

    valid_layers = ('SRTM1', 'SRTM3')
    tile_url = 'https://s3.amazonaws.com/elevation-tiles-prod/skadi/{ns}{lat:02d}/{ns}{lat:02d}{ew}{lon:03d}.hgt.gz'

    def __init__(self, layer: str,
                 bnds: Tuple[float, float, float, float],
                 fpath: str, cleanup: bool = True):
        if layer not in self.valid_layers:
            raise ValueError(f'SRTM: {layer} is invalid layer\n'
                             f'Options:{self.valid_layers}\n')
        if not (bnds[2] > bnds[0] and bnds[3] > bnds[1]):
            raise ValueError('SRTM: bounds should be northing and easting!')
        self.layer = layer
        self.bnds = bnds
        out_dir = os.path.dirname(os.path.abspath(fpath))
        os.makedirs(out_dir, exist_ok=True)
        self.fpath = fpath

    def _tile(self, lat: int, lon: int) -> np.ndarray:
        import requests
        ns = 'N' if lat >= 0 else 'S'
        ew = 'E' if lon >= 0 else 'W'
        url = self.tile_url.format(ns=ns, lat=abs(lat), ew=ew, lon=abs(lon))
        resp = requests.get(url, timeout=(4, 120))
        resp.raise_for_status()
        raw = gzip.decompress(resp.content)
        n = int(math.isqrt(len(raw) // 2))
        data = np.frombuffer(raw, dtype='>i2').reshape(n, n).astype(
            np.float32)
        data[data == -32768] = np.nan
        return data

    def download(self) -> None:
        """Mosaic the 1x1-degree tiles covering the bounds and clip."""
        try:
            west, south, east, north = self.bnds
            lat0, lat1 = math.floor(south), math.ceil(north) - 1
            lon0, lon1 = math.floor(west), math.ceil(east) - 1
            tiles = {}
            n_px = None
            for lat in range(lat0, lat1 + 1):
                for lon in range(lon0, lon1 + 1):
                    t = self._tile(lat, lon)
                    n_px = t.shape[0]
                    tiles[(lat, lon)] = t
            # each tile spans [lat, lat+1] x [lon, lon+1] with n_px samples
            # (1-px overlap between tiles; keep the simple paste)
            step = n_px - 1
            h = (lat1 - lat0 + 1) * step + 1
            w = (lon1 - lon0 + 1) * step + 1
            big = np.full((h, w), np.nan, np.float32)
            for (lat, lon), t in tiles.items():
                r0 = (lat1 - lat) * step
                c0 = (lon - lon0) * step
                big[r0:r0 + n_px, c0:c0 + n_px] = t
            res = 1.0 / step
            big_bounds = (lon0, lat0, lon1 + 1 + res, lat1 + 1 + res)
            # clip to requested bounds
            row0 = int((big_bounds[3] - north) / res)
            row1 = int(math.ceil((big_bounds[3] - south) / res))
            col0 = int((west - big_bounds[0]) / res)
            col1 = int(math.ceil((east - big_bounds[0]) / res))
            clip = big[max(row0, 0):row1, max(col0, 0):col1]
            clip_bounds = (big_bounds[0] + max(col0, 0) * res,
                           big_bounds[3] - row1 * res,
                           big_bounds[0] + col1 * res,
                           big_bounds[3] - max(row0, 0) * res)
            write_geotiff(self.fpath, np.nan_to_num(clip), clip_bounds,
                          epsg=4326)
        except Exception as exc:
            raise SRTMError(
                f'SRTM: something went wrong with {self.layer}!') from exc
