"""The region's terrain, made by the benchmark.

- :func:`synthetic_dem_lonlat` is a frozen copy of the port's synthetic
  DEM generator (``data/synthetic.py``): the same ridged octaves over the
  same lon/lat bounds give the same elevations, whatever the program's
  copy later becomes.
- :func:`write_dem_tiff` writes it as an uncompressed float32 GeoTIFF in
  EPSG:4326, the layout of a downloaded SRTM tile, where the terrain chain
  finds a saved ``SRTM1`` raster (``<data_dir>/srtm1.tif``).
- :func:`region` and :func:`reproject` work out the run grid and resample
  the DEM onto it with the ellipsoidal Albers equal-area projection of
  ESRI:102008 (Snyder, USGS PP 1395, ch. 14) and bilinear interpolation,
  for the plain reference.

Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import math
import os
import struct
from typing import Tuple

import numpy as np

# the synthetic generator's defaults: ~100 m cells in lon/lat
DEM_RES_DEG = 1. / 3600. / 3. * 10
# the lon/lat pad the terrain chain adds around the region's bounds
DEM_PAD_DEG = 0.01


def synthetic_dem_lonlat(bnds, res_deg: float = DEM_RES_DEG,
                         base_elevation: float = 1800.,
                         relief: float = 900.) -> np.ndarray:
    """Deterministic multi-octave ridge terrain over lon/lat bounds, row 0
    north, float32."""
    west, south, east, north = bnds
    ncol = max(int(round((east - west) / res_deg)), 8)
    nrow = max(int(round((north - south) / res_deg)), 8)
    lon = np.linspace(west, east, ncol)[None, :]
    lat = np.linspace(north, south, nrow)[:, None]
    seed = int.from_bytes(hashlib.sha256(
        f'{round(west, 4)}_{round(south, 4)}'.encode()).digest()[:4],
        'little')
    rng = np.random.default_rng(seed)
    z = np.zeros((nrow, ncol))
    for octave in range(5):
        k = 2.0 ** octave
        amp = relief / (1.6 ** octave)
        th = rng.uniform(0, np.pi)
        ph = rng.uniform(0, 2 * np.pi)
        freq = k * 4.0
        u = (np.cos(th) * lon + np.sin(th) * lat) * 2 * np.pi * freq
        z = z + amp * np.abs(np.sin(u + ph))
    z = base_elevation + z - z.mean()
    return z.astype(np.float32)


def write_dem_tiff(fpath: str, dem: np.ndarray, bounds) -> None:
    """An uncompressed, single-strip, little-endian float32 GeoTIFF in
    EPSG:4326 (north-up, ``bounds`` = west, south, east, north)."""
    dem = np.ascontiguousarray(dem, '<f4')
    nrow, ncol = dem.shape
    dx = (bounds[2] - bounds[0]) / ncol
    dy = (bounds[3] - bounds[1]) / nrow
    geokeys = [1, 1, 0, 3, 1024, 0, 1, 2, 1025, 0, 1, 1, 2048, 0, 1, 4326]
    extra = {  # tag: (type, values); 3 = SHORT, 4 = LONG, 12 = DOUBLE
        33550: (12, [dx, dy, 0.]),
        33922: (12, [0., 0., 0., bounds[0], bounds[3], 0.]),
        34735: (3, geokeys),
    }
    fmt = {3: 'H', 4: 'I', 12: 'd'}
    size = {3: 2, 4: 4, 12: 8}
    n_tags = 11 + len(extra)
    ifd_at = 8
    data_at = ifd_at + 2 + 12 * n_tags + 4
    blobs = b''
    tags = []

    def put(tag, typ, vals):
        nonlocal blobs
        raw = struct.pack('<' + fmt[typ] * len(vals), *vals)
        if len(raw) <= 4:
            tags.append((tag, typ, len(vals), raw.ljust(4, b'\0')))
        else:
            tags.append((tag, typ, len(vals),
                         struct.pack('<I', data_at + len(blobs))))
            blobs += raw + b'\0' * (len(raw) % 2)

    pixels = dem.tobytes()
    for tag, typ, vals in [(256, 4, [ncol]), (257, 4, [nrow]),
                           (258, 3, [32]), (259, 3, [1]), (262, 3, [1])]:
        put(tag, typ, vals)
    strip_tag = len(tags)
    put(273, 4, [0])
    for tag, typ, vals in [(277, 3, [1]), (278, 4, [nrow]),
                           (279, 4, [len(pixels)]), (284, 3, [1]),
                           (339, 3, [3])]:
        put(tag, typ, vals)
    for tag, (typ, vals) in sorted(extra.items()):
        put(tag, typ, vals)
    pix_at = data_at + len(blobs)
    tags[strip_tag] = (273, 4, 1, struct.pack('<I', pix_at))
    tags.sort(key=lambda t: t[0])
    out = b'II' + struct.pack('<HI', 42, ifd_at) + struct.pack('<H', n_tags)
    for tag, typ, count, value in tags:
        out += struct.pack('<HHI', tag, typ, count) + value
    out += struct.pack('<I', 0) + blobs + pixels
    tmp = fpath + '.part'
    with open(tmp, 'wb') as fobj:
        fobj.write(out)
    os.replace(tmp, fpath)


class Albers102008:
    """ESRI:102008, North America Albers equal-area conic on GRS80:
    latitude of origin 40, central meridian -96, parallels 20 and 60."""

    def __init__(self):
        a, f = 6378137.0, 1.0 / 298.257222101
        self.a, self.e2 = a, f * (2.0 - f)
        self.e = math.sqrt(self.e2)
        self.lon0 = math.radians(-96.)
        phi0, phi1, phi2 = map(math.radians, (40., 20., 60.))
        m1, m2 = self._m(phi1), self._m(phi2)
        q0, q1, q2 = self._q(phi0), self._q(phi1), self._q(phi2)
        self.n = (m1 * m1 - m2 * m2) / (q2 - q1)
        self.c = m1 * m1 + self.n * q1
        self.rho0 = a * math.sqrt(self.c - self.n * q0) / self.n

    def _m(self, phi):
        s = math.sin(phi)
        return math.cos(phi) / math.sqrt(1.0 - self.e2 * s * s)

    def _q(self, phi):
        s, e = np.sin(phi), self.e
        return (1.0 - self.e2) * (s / (1.0 - self.e2 * s * s) - (
            1.0 / (2.0 * e)) * np.log((1.0 - e * s) / (1.0 + e * s)))

    def forward(self, lon, lat):
        lam = np.radians(np.asarray(lon, float))
        phi = np.radians(np.asarray(lat, float))
        rho = self.a * np.sqrt(self.c - self.n * self._q(phi)) / self.n
        theta = self.n * (lam - self.lon0)
        return rho * np.sin(theta), self.rho0 - rho * np.cos(theta)

    def inverse(self, x, y):
        x, y = np.asarray(x, float), np.asarray(y, float)
        rho = np.hypot(x, self.rho0 - y)
        theta = np.arctan2(x, self.rho0 - y)
        q = (self.c - (rho * self.n / self.a) ** 2) / self.n
        lam = self.lon0 + theta / self.n
        phi = np.arcsin(np.clip(q / 2.0, -1.0, 1.0))
        e, e2 = self.e, self.e2
        for _ in range(8):
            s = np.sin(phi)
            denom = 1.0 - e2 * s * s
            phi = phi + ((denom ** 2) / (2.0 * np.cos(phi))) * (
                q / (1.0 - e2) - s / denom
                + (1.0 / (2.0 * e)) * np.log((1.0 - e * s) / (1.0 + e * s)))
        return np.degrees(lam), np.degrees(phi)


def region(cfg: dict):
    """(shape (nrow, ncol), projected bounds (west, south, east, north),
    lon/lat bounds) of a configuration's region, the grid the reference's
    ``Simulator`` works out (row 0 south; east and north are the last grid
    points)."""
    if cfg['projected_crs'] != 'ESRI:102008':
        raise ValueError(f'the benchmark projects ESRI:102008 only, not '
                         f'{cfg["projected_crs"]}')
    proj = Albers102008()
    west, south = proj.forward(*cfg['southwest_lonlat'])
    res = float(cfg['resolution'])
    ncol = int(round(cfg['region_width_km'][0] * 1000. / res))
    nrow = int(round(cfg['region_width_km'][1] * 1000. / res))
    bounds = (float(west), float(south), float(west) + (ncol - 1) * res,
              float(south) + (nrow - 1) * res)
    lon, lat = proj.inverse([bounds[0], bounds[0], bounds[2], bounds[2]],
                            [bounds[1], bounds[3], bounds[1], bounds[3]])
    lonlat = (float(lon.min()), float(lat.min()), float(lon.max()),
              float(lat.max()))
    return (nrow, ncol), bounds, lonlat


def dem_bounds(lonlat) -> Tuple[float, float, float, float]:
    """The lon/lat bounds of the DEM raster: the region's, padded."""
    return tuple(v + p for v, p in zip(
        lonlat, (-DEM_PAD_DEG, -DEM_PAD_DEG, DEM_PAD_DEG, DEM_PAD_DEG)))


def make_dem(cfg: dict):
    """(the DEM float32, row 0 north, and its lon/lat bounds) of a
    configuration's region."""
    bnds = dem_bounds(region(cfg)[2])
    return synthetic_dem_lonlat(bnds), bnds


def reproject(dem: np.ndarray, dem_bnds, cfg: dict) -> np.ndarray:
    """The DEM on the run grid, float64, row 0 south: each cell centre's
    lon/lat, bilinear between the raster's pixel centres (edge values
    repeated past the outermost ones)."""
    from scipy.ndimage import map_coordinates
    (nrow, ncol), bounds, _ = region(cfg)
    res = float(cfg['resolution'])
    xs = bounds[0] + (np.arange(ncol) + 0.5) * res
    ys = bounds[3] - (np.arange(nrow) + 0.5) * res
    xg, yg = np.meshgrid(xs, ys)
    lon, lat = Albers102008().inverse(xg.ravel(), yg.ravel())
    snrow, sncol = dem.shape
    sdx = (dem_bnds[2] - dem_bnds[0]) / sncol
    sdy = (dem_bnds[3] - dem_bnds[1]) / snrow
    cols = (lon - dem_bnds[0]) / sdx - 0.5
    rows = (dem_bnds[3] - lat) / sdy - 0.5
    out = map_coordinates(np.asarray(dem, np.float64), [rows, cols],
                          order=1, mode='nearest')
    return np.ascontiguousarray(np.flipud(out.reshape(nrow, ncol)))
