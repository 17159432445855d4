"""Copy of ``ssrs_tpu/data/crs.py``, unchanged apart from imports.

Pure-Python coordinate-reference-system engine.

The reference delegates all CRS work to rasterio/PROJ
(ssrs/raster.py:87-144,169-203). Neither rasterio nor pyproj is available
in this environment, so the projections SSRS actually uses are implemented
directly from Snyder, "Map Projections — A Working Manual" (USGS PP 1395):

- geographic lon/lat (EPSG:4326, NAD83 EPSG:4269 treated as equivalent
  at SSRS's accuracy needs),
- Albers Equal-Area Conic (ellipsoidal): ESRI:102008 (North America),
  EPSG:5070 (CONUS), and PROJ4 ``+proj=aea`` strings,
- Transverse Mercator / UTM: EPSG:326xx/327xx and PROJ4 ``+proj=utm``
  strings (the reference's ``get_utm_string``, ssrs/raster.py:184-203).

Validation (tests/test_crs.py): round-trip closure to <1e-9 deg, the
equal-area Jacobian invariant for Albers, and UTM scale/false-easting
invariants.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np

# GRS80 & WGS84 ellipsoids (semi-major axis, flattening)
ELLIPSOIDS = {
    'GRS80': (6378137.0, 1.0 / 298.257222101),
    'WGS84': (6378137.0, 1.0 / 298.257223563),
}


@dataclass(frozen=True)
class Ellipsoid:
    a: float
    f: float

    @property
    def e2(self) -> float:
        return self.f * (2.0 - self.f)

    @property
    def e(self) -> float:
        return math.sqrt(self.e2)


def _ellipsoid(name: str) -> Ellipsoid:
    a, f = ELLIPSOIDS[name]
    return Ellipsoid(a, f)


class Geographic:
    """Identity projection (lon/lat degrees)."""

    is_projected = False

    def forward(self, lon, lat):
        return np.asarray(lon, float), np.asarray(lat, float)

    def inverse(self, x, y):
        return np.asarray(x, float), np.asarray(y, float)


class AlbersEqualArea:
    """Ellipsoidal Albers equal-area conic (Snyder ch. 14)."""

    is_projected = True

    def __init__(self, lat0: float, lon0: float, sp1: float, sp2: float,
                 fe: float = 0., fn: float = 0.,
                 ellipsoid: str = 'GRS80'):
        ell = _ellipsoid(ellipsoid)
        self.a, self.e2, self.e = ell.a, ell.e2, ell.e
        self.lon0 = math.radians(lon0)
        self.fe, self.fn = fe, fn
        phi0, phi1, phi2 = map(math.radians, (lat0, sp1, sp2))
        m1, m2 = self._m(phi1), self._m(phi2)
        q0, q1, q2 = self._q(phi0), self._q(phi1), self._q(phi2)
        self.n = (m1 * m1 - m2 * m2) / (q2 - q1)
        self.c = m1 * m1 + self.n * q1
        self.rho0 = self.a * math.sqrt(self.c - self.n * q0) / self.n

    def _m(self, phi: float) -> float:
        s = math.sin(phi)
        return math.cos(phi) / math.sqrt(1.0 - self.e2 * s * s)

    def _q(self, phi):
        s = np.sin(phi)
        e = self.e
        return (1.0 - self.e2) * (s / (1.0 - self.e2 * s * s)
                                  - (1.0 / (2.0 * e)) * np.log(
                                      (1.0 - e * s) / (1.0 + e * s)))

    def forward(self, lon, lat):
        lam = np.radians(np.asarray(lon, float))
        phi = np.radians(np.asarray(lat, float))
        q = self._q(phi)
        rho = self.a * np.sqrt(self.c - self.n * q) / self.n
        theta = self.n * (lam - self.lon0)
        x = rho * np.sin(theta) + self.fe
        y = self.rho0 - rho * np.cos(theta) + self.fn
        return x, y

    def inverse(self, x, y):
        x = np.asarray(x, float) - self.fe
        y = np.asarray(y, float) - self.fn
        rho = np.hypot(x, self.rho0 - y)
        theta = np.arctan2(np.sign(self.n) * x,
                           np.sign(self.n) * (self.rho0 - y))
        q = (self.c - (rho * self.n / self.a) ** 2) / self.n
        lam = self.lon0 + theta / self.n
        # iterate for phi (Snyder 3-16)
        phi = np.arcsin(np.clip(q / 2.0, -1.0, 1.0))
        for _ in range(8):
            s = np.sin(phi)
            e, e2 = self.e, self.e2
            denom = 1.0 - e2 * s * s
            corr = ((denom ** 2) / (2.0 * np.cos(phi))) * (
                q / (1.0 - e2) - s / denom
                + (1.0 / (2.0 * e)) * np.log((1.0 - e * s) / (1.0 + e * s)))
            phi = phi + corr
        return np.degrees(lam), np.degrees(phi)


class TransverseMercator:
    """Ellipsoidal transverse Mercator (Snyder ch. 8), UTM parameters."""

    is_projected = True

    def __init__(self, lon0: float, lat0: float = 0., k0: float = 0.9996,
                 fe: float = 500000., fn: float = 0.,
                 ellipsoid: str = 'WGS84'):
        ell = _ellipsoid(ellipsoid)
        self.a, self.e2 = ell.a, ell.e2
        self.ep2 = self.e2 / (1.0 - self.e2)
        self.k0, self.fe, self.fn = k0, fe, fn
        self.lon0 = math.radians(lon0)
        self.lat0 = math.radians(lat0)
        self.m0 = self._mdist(self.lat0)

    def _mdist(self, phi):
        e2 = self.e2
        e4, e6 = e2 * e2, e2 * e2 * e2
        return self.a * (
            (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
            - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * phi)
            + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * phi)
            - (35 * e6 / 3072) * np.sin(6 * phi))

    def forward(self, lon, lat):
        lam = np.radians(np.asarray(lon, float))
        phi = np.radians(np.asarray(lat, float))
        e2, ep2, a, k0 = self.e2, self.ep2, self.a, self.k0
        s, c = np.sin(phi), np.cos(phi)
        n = a / np.sqrt(1 - e2 * s * s)
        t = np.tan(phi) ** 2
        cc = ep2 * c * c
        aa = (lam - self.lon0) * c
        m = self._mdist(phi)
        x = k0 * n * (aa + (1 - t + cc) * aa ** 3 / 6
                      + (5 - 18 * t + t * t + 72 * cc - 58 * ep2)
                      * aa ** 5 / 120) + self.fe
        y = k0 * (m - self.m0 + n * np.tan(phi) * (
            aa ** 2 / 2 + (5 - t + 9 * cc + 4 * cc * cc) * aa ** 4 / 24
            + (61 - 58 * t + t * t + 600 * cc - 330 * ep2)
            * aa ** 6 / 720)) + self.fn
        return x, y

    def inverse(self, x, y):
        x = np.asarray(x, float) - self.fe
        y = np.asarray(y, float) - self.fn
        e2, ep2, a, k0 = self.e2, self.ep2, self.a, self.k0
        m = self.m0 + y / k0
        e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
        mu = m / (a * (1 - e2 / 4 - 3 * e2 * e2 / 64
                       - 5 * e2 ** 3 / 256))
        phi1 = (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu)
                + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu)
                + (151 * e1 ** 3 / 96) * np.sin(6 * mu)
                + (1097 * e1 ** 4 / 512) * np.sin(8 * mu))
        s1, c1 = np.sin(phi1), np.cos(phi1)
        t1 = np.tan(phi1) ** 2
        cc1 = ep2 * c1 * c1
        n1 = a / np.sqrt(1 - e2 * s1 * s1)
        r1 = a * (1 - e2) / (1 - e2 * s1 * s1) ** 1.5
        d = x / (n1 * k0)
        phi = phi1 - (n1 * np.tan(phi1) / r1) * (
            d * d / 2 - (5 + 3 * t1 + 10 * cc1 - 4 * cc1 * cc1 - 9 * ep2)
            * d ** 4 / 24
            + (61 + 90 * t1 + 298 * cc1 + 45 * t1 * t1 - 252 * ep2
               - 3 * cc1 * cc1) * d ** 6 / 720)
        lam = self.lon0 + (d - (1 + 2 * t1 + cc1) * d ** 3 / 6
                           + (5 - 2 * cc1 + 28 * t1 - 3 * cc1 * cc1
                              + 8 * ep2 + 24 * t1 * t1) * d ** 5 / 120) / c1
        return np.degrees(lam), np.degrees(phi)


# ---------------------------------------------------------------------------

_NAMED = {
    'EPSG:4326': lambda: Geographic(),
    'EPSG:4269': lambda: Geographic(),  # NAD83 geographic ~ WGS84 here
    # North America Albers Equal Area Conic
    'ESRI:102008': lambda: AlbersEqualArea(40., -96., 20., 60.,
                                           ellipsoid='GRS80'),
    # NAD83 / Conus Albers
    'EPSG:5070': lambda: AlbersEqualArea(23., -96., 29.5, 45.5,
                                         ellipsoid='GRS80'),
}


class CRSError(ValueError):
    pass


def get_crs(crs: Union[str, Geographic, AlbersEqualArea,
                       TransverseMercator]):
    """Resolve an EPSG/ESRI/PROJ4 string (or a projection object) to a
    projection object; mirrors ``get_rasterio_crs_object``
    (ssrs/raster.py:169-181) in error behavior."""
    if not isinstance(crs, str):
        return crs
    key = crs.strip()
    upper = key.upper()
    if upper in _NAMED:
        return _NAMED[upper]()
    # EPSG UTM codes
    m = re.fullmatch(r'EPSG:(32[67])(\d\d)', upper)
    if m:
        zone = int(m.group(2))
        south = m.group(1) == '327'
        return TransverseMercator(lon0=zone * 6 - 183,
                                  fn=10000000. if south else 0.)
    if key.startswith('+'):
        params = dict()
        for tok in key.split():
            if '=' in tok:
                k, v = tok[1:].split('=', 1)
                params[k] = v
            else:
                params[tok[1:]] = True
        proj = params.get('proj')
        if proj == 'utm':
            zone = int(params['zone'])
            return TransverseMercator(
                lon0=zone * 6 - 183,
                fn=10000000. if params.get('south') else 0.,
                ellipsoid=params.get('ellps', 'WGS84')
                if params.get('ellps', 'WGS84') in ELLIPSOIDS else 'WGS84')
        if proj == 'aea':
            return AlbersEqualArea(
                lat0=float(params.get('lat_0', 0.)),
                lon0=float(params.get('lon_0', 0.)),
                sp1=float(params.get('lat_1', 20.)),
                sp2=float(params.get('lat_2', 60.)),
                fe=float(params.get('x_0', 0.)),
                fn=float(params.get('y_0', 0.)),
                ellipsoid=params.get('ellps', 'GRS80')
                if params.get('ellps', 'GRS80') in ELLIPSOIDS else 'GRS80')
        if proj in ('longlat', 'latlong', 'lonlat'):
            return Geographic()
    raise CRSError(
        f'{crs} is an invalid or unsupported crs!\n'
        'Supported: EPSG:4326/4269, ESRI:102008, EPSG:5070, EPSG UTM '
        '(326xx/327xx), PROJ4 +proj=utm/aea/longlat')


def transform_coordinates(in_crs, out_crs, in_x, in_y):
    """Transform points between CRSs; API-compatible with the reference
    (ssrs/raster.py:87-144): scalars become length-1 lists, ndarray shape
    round-trips."""
    scalar_in = isinstance(in_x, (int, float))
    in_x = [in_x] if scalar_in else in_x
    in_y = [in_y] if isinstance(in_y, (int, float)) else in_y
    out_shape = None
    if isinstance(in_x, np.ndarray):
        out_shape = in_x.shape
        in_x = np.ravel(in_x)
        in_y = np.ravel(in_y)
    in_x = np.asarray(in_x, float)
    in_y = np.asarray(in_y, float)
    assert in_x.size == in_y.size

    src = get_crs(in_crs)
    dst = get_crs(out_crs)
    lon, lat = src.inverse(in_x, in_y)
    out_x, out_y = dst.forward(lon, lat)
    if out_shape is not None:
        return out_x.reshape(out_shape), out_y.reshape(out_shape)
    return out_x, out_y


def transform_bounds(src_bounds, src_crs_string, dest_crs_string,
                     pad: float = 0.):
    """Bounds of the region in the destination CRS containing the source
    bounds' corner points (ssrs/raster.py:52-84)."""
    xs = [src_bounds[0], src_bounds[0], src_bounds[2], src_bounds[2]]
    ys = [src_bounds[1], src_bounds[3], src_bounds[1], src_bounds[3]]
    out_x, out_y = transform_coordinates(src_crs_string, dest_crs_string,
                                         xs, ys)
    dest = (min(out_x), min(out_y), max(out_x), max(out_y))
    return [v + p for v, p in zip(dest, (-pad, -pad, pad, pad))]


def get_utm_string(west_lon: float) -> str:
    """PROJ4 UTM string for a longitude (ssrs/raster.py:184-203)."""
    zone_number = int((west_lon + 180) / 6) + 1
    return (f'+proj=utm +zone={zone_number} +datum=WGS84 +units=m'
            f'+no_defs +ellps=WGS84 +towgs84=0,0,0')
