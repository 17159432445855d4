"""Copy of ``ssrs_tpu/data/synthetic.py``, unchanged apart from imports.

Synthetic terrain source for offline/reproducible runs.

The reference has no offline mode — every run needs 3DEP/SRTM
connectivity. This source generates a deterministic, terrain-like DEM from
the request bounds (seeded by the bounds themselves, so the same region
always yields the same terrain) and writes it through the same GeoTIFF
cache path, letting the entire pipeline, the examples, and the test suite
run with zero network.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Tuple

import numpy as np

from .geotiff import write_geotiff


def synthetic_dem_lonlat(bnds: Tuple[float, float, float, float],
                         res_deg: float = 1. / 3600. / 3. * 10,
                         base_elevation: float = 1800.,
                         relief: float = 900.) -> np.ndarray:
    """Deterministic multi-octave ridge terrain over lon/lat bounds."""
    west, south, east, north = bnds
    ncol = max(int(round((east - west) / res_deg)), 8)
    nrow = max(int(round((north - south) / res_deg)), 8)
    lon = np.linspace(west, east, ncol)[None, :]
    lat = np.linspace(north, south, nrow)[:, None]  # row 0 north

    seed = int.from_bytes(hashlib.sha256(
        f'{round(west, 4)}_{round(south, 4)}'.encode()).digest()[:4],
        'little')
    rng = np.random.default_rng(seed)

    z = np.zeros((nrow, ncol))
    # octaves of oriented sinusoidal ridges — cheap but terrain-plausible
    for octave in range(5):
        k = 2.0 ** octave
        amp = relief / (1.6 ** octave)
        th = rng.uniform(0, np.pi)
        ph = rng.uniform(0, 2 * np.pi)
        freq = k * 4.0  # cycles per degree
        u = (np.cos(th) * lon + np.sin(th) * lat) * 2 * np.pi * freq
        z = z + amp * np.abs(np.sin(u + ph))  # ridged
    z = base_elevation + z - z.mean()
    return z.astype(np.float32), (west, south, east, north)


class SyntheticTerrain:
    """Terrain source writing a synthetic DEM GeoTIFF (offline mode)."""

    valid_layers = ('SYNTHETIC',)

    def __init__(self, layer: str,
                 bnds: Tuple[float, float, float, float],
                 fpath: str):
        self.bnds = bnds
        self.fpath = fpath

    def download(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.fpath)),
                    exist_ok=True)
        dem, bounds = synthetic_dem_lonlat(self.bnds)
        write_geotiff(self.fpath, dem, bounds, epsg=4326)
