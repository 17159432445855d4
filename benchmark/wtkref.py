"""The plain reference of the WindToolKit (WTK) modes: a run's datetimes,
its winds on the grid and its orographic updraft under them, worked out
again in float64 from the configuration, the seeds and the stand-in's
values (``wtk.py``), never from the program's files or caches.

- :func:`seasonal_datetimes` (with the sunrise and sunset it needs) is a
  frozen copy of the port's seeded seasonal sampler (``utils.py``), so
  that a job's seed gives its datetimes, and the tracks' starts are the
  draws after them;
- :func:`read_sites` is the sites the program's WTK reader takes from the
  archive: those strictly inside the region's lon/lat bounds padded by
  :data:`READ_PAD`, scanned from the first to (not including) the last
  site of the latitude band (ssrs/wtk/wtk.py:73-96);
- :class:`Winds` projects them with ESRI:102008 (``terrain.py``), and
  interpolates a datetime's winds onto the grid's points as
  ``griddata(method='linear')`` does, with the nearest site outside the
  sites' hull: the speed and direction decomposed into east and north
  components, each interpolated, recomposed (ssrs/simulator.py:765-792);
- :class:`Fields` holds the region's slope and aspect and gives a
  datetime's thresholded orographic updraft under the per-cell winds.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from datetime import date, datetime, time, timedelta

import numpy as np
import torch

from . import reference as ref
from . import terrain, wtk

# the lon/lat pad the program's WTK reader adds to the region's bounds
READ_PAD = 0.02
# a case's name (the Simulator's time_format)
CASE_FORMAT = 'y%Ym%md%dh%H'


# ---- frozen copy of the seeded seasonal sampler ---------------------------

def _solar_noon_and_halfday(lon: float, lat: float, this_date: date):
    """Solar noon (fractional UTC hours) and half-day length (hours)."""
    n = this_date.toordinal() - date(2000, 1, 1).toordinal()
    jstar = n - lon / 360.0
    m = math.radians((357.5291 + 0.98560028 * jstar) % 360.)
    c = (1.9148 * math.sin(m) + 0.0200 * math.sin(2 * m)
         + 0.0003 * math.sin(3 * m))
    lam = math.radians((math.degrees(m) + c + 180. + 102.9372) % 360.)
    j_transit = 2451545.0 + jstar + 0.0053 * math.sin(m) \
        - 0.0069 * math.sin(2 * lam)
    decl = math.asin(math.sin(lam) * math.sin(math.radians(23.4397)))
    phi = math.radians(lat)
    cos_h = ((math.sin(math.radians(-0.833)) - math.sin(phi)
              * math.sin(decl)) / (math.cos(phi) * math.cos(decl)))
    cos_h = min(max(cos_h, -1.0), 1.0)
    halfday_hours = math.degrees(math.acos(cos_h)) / 15.0
    noon_utc = 12.0 + (j_transit - (2451545.0 + n)) * 24.0
    return noon_utc, halfday_hours


def conus_timezone_name(lon: float, lat: float):
    """IANA timezone name of a CONUS lon/lat (a piecewise table of the
    zone boundaries), or None outside CONUS."""
    if not (-125.0 <= lon <= -66.0 and 24.0 <= lat <= 50.0):
        return None
    if -114.85 <= lon <= -109.05 and 31.3 <= lat <= 37.0:
        return 'America/Phoenix'
    if lat > 42.0:
        lon_pm = -117.0
    elif lat >= 35.0:
        lon_pm = -114.05
    else:
        lon_pm = -114.5
    if lon < lon_pm:
        return 'America/Los_Angeles'
    if lat >= 46.0:
        lon_mc = -104.0
    elif lat >= 43.0:
        lon_mc = -101.0
    elif lat >= 40.0:
        lon_mc = -101.5
    elif lat >= 37.0:
        lon_mc = -102.0
    elif lat >= 32.0:
        lon_mc = -103.0
    else:
        lon_mc = -105.0
    if lon < lon_mc:
        return 'America/Denver'
    if lat >= 41.7:
        lon_ce = -87.6
    elif lat >= 38.0:
        lon_ce = -87.5
    elif lat >= 35.0:
        lon_ce = -86.3
    elif lat >= 31.0:
        lon_ce = -85.0
    else:
        lon_ce = -85.2
    if lon < lon_ce:
        return 'America/Chicago'
    return 'America/New_York'


def utc_offset_hours(lon: float, lat: float, this_date: date) -> float:
    """The UTC offset at noon (DST-aware) from the zone table and the
    system's tzdata; ``round(lon / 15)`` outside CONUS or without it."""
    name = conus_timezone_name(lon, lat)
    if name is not None:
        try:
            from zoneinfo import ZoneInfo
            noon = datetime.combine(this_date, time(12, 0),
                                    tzinfo=ZoneInfo(name))
            return noon.utcoffset().total_seconds() / 3600.0
        except (ImportError, KeyError, OSError):  # no tzdata
            pass
    return float(round(lon / 15.0))


def sunrise_sunset(lonlat, this_date: date):
    """Local sunrise and sunset (``datetime.time``) at a lon/lat."""
    lon, lat = lonlat
    noon_utc, halfday = _solar_noon_and_halfday(lon, lat, this_date)
    tz_offset = utc_offset_hours(lon, lat, this_date)

    def to_time(hours: float) -> time:
        hours = hours % 24.0
        hh = int(hours)
        mm = int((hours - hh) * 60)
        ss = int(((hours - hh) * 60 - mm) * 60)
        return time(hh, mm, ss)

    return to_time(noon_utc - halfday + tz_offset), \
        to_time(noon_utc + halfday + tz_offset)


def seasonal_datetimes(years, seasonal_start, seasonal_end, timeofday: str,
                       count: int, lonlat, rng: np.random.Generator) -> list:
    """``count`` distinct hours drawn from ``rng``: a year, a second of the
    season, then an hour of the chosen part of that day's daylight."""
    chosen = set()
    guard = 0
    while len(chosen) < count:
        guard += 1
        if guard > 100 * count + 1000:
            raise RuntimeError('seasonal datetime sampling did not '
                               'converge; widen the season window')
        year = int(rng.choice(years))
        start_date = datetime(year, *seasonal_start)
        end_date = datetime(year, *seasonal_end)
        span = (end_date - start_date).total_seconds()
        rnd = start_date + timedelta(seconds=float(rng.random()) * span)
        rnd = rnd.replace(microsecond=0, second=0, minute=0)
        srise, sset = sunrise_sunset(lonlat, rnd.date())
        daytime = np.arange(srise.hour + 1, sset.hour + 1)
        split = np.array_split(daytime, 3)
        parts = {'morning': split[0], 'afternoon': split[1],
                 'evening': split[2], 'daytime': daytime}
        tod = timeofday.lower()
        if tod not in parts:
            raise ValueError(f'Invalid time of day:{timeofday}')
        rnd = rnd.replace(hour=int(rng.choice(list(parts[tod]))))
        chosen.add(rnd)
    return list(chosen)


# ---- a run's cases ------------------------------------------------------

def is_wtk(cfg: dict) -> bool:
    """Whether the configuration's winds come from WTK (snapshot or
    seasonal mode)."""
    return cfg['sim_mode'].lower() in ('snapshot', 'seasonal')


def years(cfg: dict) -> list:
    """The stand-in's years (the run's ``wtk_local_years``)."""
    return [int(y) for y in cfg['wtk_standin']['years']]


def datetimes(cfg: dict, rng: np.random.Generator) -> list:
    """The run's datetimes: seasonal ones drawn from the run's generator
    ``rng`` (its first draws), or the snapshot's one."""
    mode = cfg['sim_mode'].lower()
    if mode == 'seasonal':
        lonlat = terrain.region(cfg)[2]
        return seasonal_datetimes(
            years(cfg), tuple(cfg['seasonal_start']),
            tuple(cfg['seasonal_end']), cfg['seasonal_timeofday'],
            int(cfg['seasonal_count']), lonlat[0:2], rng)
    if mode == 'snapshot':
        return [datetime(*cfg['snapshot_datetime'])]
    raise ValueError(f'sim_mode {cfg["sim_mode"]!r} has no WTK datetimes')


def cases(cfg: dict, seed: int) -> dict:
    """{case id: datetime} of a job with ``sim_seed`` ``seed``."""
    rng = np.random.default_rng(seed)
    return {dt.strftime(CASE_FORMAT): dt for dt in datetimes(cfg, rng)}


def hour_of_year(dt: datetime) -> int:
    diff = dt - datetime(dt.year, 1, 1, 0)
    return diff.days * 24 + diff.seconds // 3600


# ---- winds and fields ------------------------------------------------------

def read_sites(lat, lon, lonlat_bounds, pad: float = READ_PAD):
    """Indices of the sites the program's WTK reader takes."""
    b = [v + p for v, p in zip(lonlat_bounds, (-pad, -pad, pad, pad))]
    lat_idx = np.where((lat > b[1]) & (lat < b[3]))[0]
    lo, hi = int(lat_idx.min()), int(lat_idx.max())
    lat_band, lon_band = lat[lo:hi], lon[lo:hi]
    inside = ((lat_band > b[1]) & (lat_band < b[3])
              & (lon_band > b[0]) & (lon_band < b[2]))
    return lo + np.where(inside)[0]


class Winds:
    """A configuration's WTK winds on its grid points (west + res * col,
    south + res * row; row 0 south): the sites' triangulation and each
    point's three sites and barycentric weights, or its nearest site
    outside the hull, worked out once; float64 on ``device``."""

    def __init__(self, cfg: dict, device):
        from scipy.spatial import Delaunay, cKDTree
        if cfg['wtk_interp_type'] != 'linear':
            raise ValueError('the reference interpolates WTK winds '
                             f'linearly, not {cfg["wtk_interp_type"]!r}')
        (nrow, ncol), bounds, lonlat = terrain.region(cfg)
        standin = cfg['wtk_standin']
        lat, lon = wtk.sites(lonlat, float(standin['spacing_km']),
                             int(standin['seed']))
        idx = read_sites(lat, lon, lonlat)
        self.lat, self.lon = lat[idx], lon[idx]
        self.speed_layer, self.dirn_layer = wtk.layer_names(cfg)[:2]
        self.shape = (nrow, ncol)
        x, y = terrain.Albers102008().forward(self.lon, self.lat)
        points = np.stack([x, y], axis=1)
        res = float(cfg['resolution'])
        xm, ym = np.meshgrid(bounds[0] + res * np.arange(ncol),
                             bounds[1] + res * np.arange(nrow))
        xi = np.stack([xm.ravel(), ym.ravel()], axis=1)
        tri = Delaunay(points)
        simplex = tri.find_simplex(xi)
        inside = simplex >= 0
        s = np.where(inside, simplex, 0)
        trans = tri.transform[s]
        c = np.einsum('ijk,ik->ij', trans[:, :2], xi - trans[:, 2])
        weights = np.concatenate([c, 1. - c.sum(1, keepdims=True)], axis=1)
        verts = tri.simplices[s].astype(np.int64)
        if not inside.all():
            near = cKDTree(points).query(xi[~inside])[1]
            verts[~inside] = near[:, None]
            weights[~inside] = (1., 0., 0.)
        self.verts = torch.as_tensor(verts, device=device)
        self.weights = torch.as_tensor(weights, device=device)

    def at(self, dt: datetime):
        """(speed m/s, direction degrees) float64 (nrow, ncol) at ``dt``."""
        hour = hour_of_year(dt)
        speed = wtk.values(self.speed_layer, hour, self.lat, self.lon)
        dirn = np.radians(wtk.values(self.dirn_layer, hour, self.lat,
                                     self.lon))
        out = []
        for comp in (speed * np.sin(dirn), speed * np.cos(dirn)):
            v = torch.as_tensor(comp, device=self.weights.device)
            out.append((self.weights * v[self.verts]).sum(1)
                       .reshape(self.shape))
        east, north = out
        angle = torch.remainder(torch.atan2(east, north) + 2 * np.pi,
                                2 * np.pi)
        return torch.hypot(east, north), torch.rad2deg(angle)


class Fields:
    """The region's slope and aspect (from the DEM, as the uniform
    reference has them) and :class:`Winds`; :meth:`thresholded` gives a
    datetime's usable updraft. ``dtype`` is the precision of the DEM,
    stencil, winds and updraft (the control's is one below float64)."""

    def __init__(self, cfg: dict, dem, dem_bounds, device,
                 dtype=torch.float64):
        z = torch.as_tensor(terrain.reproject(dem, dem_bounds, cfg),
                            device=device).to(dtype)
        self.slope, self.aspect = ref.slope_aspect(
            z, float(cfg['resolution']))
        self.winds = Winds(cfg, device)
        self.thr = float(cfg['updraft_threshold'])
        self.dtype = dtype

    def thresholded(self, dt: datetime) -> torch.Tensor:
        speed, dirn = self.winds.at(dt)
        oro = ref.orograph(self.slope, self.aspect, speed.to(self.dtype),
                           dirn.to(self.dtype))
        return ref.threshold(oro, self.thr)
