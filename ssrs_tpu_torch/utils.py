"""Host helpers, copied from ``ssrs_tpu/utils.py``: the solar and seasonal
helpers (sunrise and sunset by NOAA's solar-position algorithm, the local
UTC offset from a bundled CONUS timezone table and the stdlib
``zoneinfo``, and the seeded sampler of seasonal datetimes), the GIS axis
and extent helpers of the figures, and the filesystem and printing
helpers. numpy and the standard library only; matplotlib inside
``create_gis_axis``."""

from __future__ import annotations

import errno
import math
import os
import shutil
from datetime import date, datetime, time, timedelta
from typing import List, Tuple

import numpy as np


# ---- solar calculations (NOAA SPA simplified; Meeus) ----------------------

def _solar_noon_and_halfday(lon: float, lat: float,
                            this_date: date) -> Tuple[float, float]:
    """Solar noon (fractional UTC hours) and half-day length (hours)."""
    n = this_date.toordinal() - date(2000, 1, 1).toordinal()
    # mean solar time approximations (NOAA)
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
    # 2451545.0 + n is 12:00 UTC on this date; offset to transit in hours
    noon_utc = 12.0 + (j_transit - (2451545.0 + n)) * 24.0
    return noon_utc, halfday_hours


def conus_timezone_name(lon: float, lat: float) -> str | None:
    """IANA timezone name for a CONUS lon/lat, or None outside CONUS.

    The reference resolves this with timezonefinder (ssrs/utils.py:15-29);
    that package is unavailable offline, so this is a bundled piecewise
    approximation of the four CONUS zone boundaries (plus the Arizona
    no-DST exception). The boundary meridians vary with latitude to track
    the real political lines (NV is Pacific, NM is Mountain, IN is
    Eastern, the El Paso and FL-panhandle splits); accuracy is within ~1
    degree of longitude of the true squiggle, which is exact for the
    reference's example regions (Altamont CA, WY, Appalachian WV/PA) and
    off by at most one zone within ~100 km of a boundary.
    """
    if not (-125.0 <= lon <= -66.0 and 24.0 <= lat <= 50.0):
        return None
    # Arizona: Mountain Standard Time year-round
    if -114.85 <= lon <= -109.05 and 31.3 <= lat <= 37.0:
        return 'America/Phoenix'
    # Pacific/Mountain boundary
    if lat > 42.0:
        lon_pm = -117.0       # OR-ID line; southern ID is Mountain
    elif lat >= 35.0:
        lon_pm = -114.05      # NV/UT and NV/AZ lines
    else:
        lon_pm = -114.5       # CA/AZ Colorado-river border
    if lon < lon_pm:
        return 'America/Los_Angeles'
    # Mountain/Central boundary
    if lat >= 46.0:
        lon_mc = -104.0       # MT/ND line
    elif lat >= 43.0:
        lon_mc = -101.0       # SD splits mid-state
    elif lat >= 40.0:
        lon_mc = -101.5       # NE splits
    elif lat >= 37.0:
        lon_mc = -102.0       # western KS counties
    elif lat >= 32.0:
        lon_mc = -103.0       # NM (Mountain) / TX (Central) line
    else:
        lon_mc = -105.0       # far-west TX (El Paso) is Mountain
    if lon < lon_mc:
        return 'America/Denver'
    # Central/Eastern boundary
    if lat >= 41.7:
        lon_ce = -87.6        # WI Central / MI Eastern (Lake Michigan)
    elif lat >= 38.0:
        lon_ce = -87.5        # IL/IN line
    elif lat >= 35.0:
        lon_ce = -86.3        # TN/KY split mid-state
    elif lat >= 31.0:
        lon_ce = -85.0        # AL/GA line
    else:
        lon_ce = -85.2        # FL panhandle split
    if lon < lon_ce:
        return 'America/Chicago'
    return 'America/New_York'


def utc_offset_hours(lon: float, lat: float, this_date: date) -> float:
    """UTC offset (hours, DST-aware) at a lon/lat on a date.

    Uses the bundled CONUS zone table + the system tzdata (stdlib
    zoneinfo), matching the reference's timezonefinder+astral behavior
    including daylight-saving transitions; falls back to the solar
    ``round(lon / 15)`` offset outside CONUS or without tzdata."""
    name = conus_timezone_name(lon, lat)
    if name is not None:
        try:
            from zoneinfo import ZoneInfo
            noon = datetime.combine(this_date, time(12, 0),
                                    tzinfo=ZoneInfo(name))
            return noon.utcoffset().total_seconds() / 3600.0
        except Exception:  # no tzdata on this system
            pass
    return float(round(lon / 15.0))


def get_sunrise_sunset_time(this_lonlat: Tuple[float, float],
                            this_date: date) -> Tuple[time, time]:
    """Local-time sunrise/sunset (API parity with ssrs/utils.py:15-29).

    The solar math is NOAA's; the local offset comes from the bundled
    CONUS timezone table + tzdata (DST-aware, matching the reference's
    timezonefinder+astral to the accuracy of the zone-boundary table)."""
    if not isinstance(this_date, date):
        raise ValueError('Provide a valid datetime.date object')
    lon, lat = this_lonlat
    noon_utc, halfday = _solar_noon_and_halfday(lon, lat, this_date)
    tz_offset = utc_offset_hours(lon, lat, this_date)
    rise = noon_utc - halfday + tz_offset
    sset = noon_utc + halfday + tz_offset

    def to_time(hours: float) -> time:
        hours = hours % 24.0
        hh = int(hours)
        mm = int((hours - hh) * 60)
        ss = int(((hours - hh) * 60 - mm) * 60)
        return time(hh, mm, ss)

    return to_time(rise), to_time(sset)


def get_seasonal_datetimes_list(years: List[int],
                                seasonal_start: Tuple[int, int],
                                seasonal_end: Tuple[int, int],
                                timeofday: str,
                                count: int,
                                lonlat: Tuple[float, float],
                                rng: np.random.Generator
                                ) -> List[datetime]:
    """Sample unique seasonal datetimes (ssrs/simulator.py:718-752),
    driven by a seeded Generator instead of the unseeded stdlib random."""
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
        srise, sset = get_sunrise_sunset_time(lonlat, rnd.date())
        daytime = np.arange(srise.hour + 1, sset.hour + 1)
        split = np.array_split(daytime, 3)
        tod = timeofday.lower()
        if tod == 'morning':
            hours = list(split[0])
        elif tod == 'afternoon':
            hours = list(split[1])
        elif tod == 'evening':
            hours = list(split[2])
        elif tod == 'daytime':
            hours = list(daytime)
        else:
            raise ValueError(f'Invalid time of day:{timeofday}\n'
                             'Options: morning, afternoon, evening, '
                             'daytime')
        rnd = rnd.replace(hour=int(rng.choice(hours)))
        chosen.add(rnd)
    return list(chosen)


# ---- figures --------------------------------------------------------------

def create_gis_axis(cur_fig, cur_ax, cur_cm=None, km_bar: float = 10.):
    """GIS axis styling — the reference's public helper name
    (ssrs/utils.py:32-71); implementation lives in
    :func:`ssrs_tpu_torch.figstyle.decorate_gis_axes` (scale bar, north
    arrow, optional colorbar, legend, equal aspect). Returns
    ``(colorbar, legend)``, either possibly None."""
    from .figstyle import decorate_gis_axes
    return decorate_gis_axes(cur_fig, cur_ax, cur_cm, km_bar)


# ---- bounds & filesystem ---------------------------------------------------

def get_extent_from_bounds(bounds, from_origin: bool = False,
                           in_km: bool = False):
    """Matplotlib extent from bounds (ssrs/utils.py:74-85)."""
    extent = (bounds[0], bounds[2], bounds[1], bounds[3])
    if from_origin:
        extent = (0., extent[1] - bounds[0], 0., extent[3] - extent[2])
    if in_km:
        extent = [v / 1000. for v in extent]
    return extent


def makedir_if_not_exists(dirname: str) -> None:
    try:
        os.makedirs(dirname)
    except OSError as exc:
        if exc.errno != errno.EEXIST:
            raise


def remove_all_dirs_in_this_dir(dname: str) -> None:
    if os.path.isdir(dname):
        for entry in os.scandir(dname):
            if entry.is_dir():
                shutil.rmtree(entry.path)


def empty_this_directory(dirname: str) -> None:
    for fname in os.listdir(dirname):
        os.remove(os.path.join(dirname, fname))


def pretty_str(label, arr) -> str:
    """Pretty-print an array assignment (ssrs/utils.py:126-167)."""
    def is_col(a):
        try:
            return a.shape[0] > 1 and a.shape[1] == 1
        except (AttributeError, IndexError):
            return False

    label = '' if label is None else label
    if label:
        label += ' = '
    if is_col(arr):
        return label + str(arr.T).replace('\n', '') + '.T'
    rows = str(arr).split('\n')
    if not rows:
        return ''
    out = label + rows[0]
    pad = ' ' * len(label)
    for line in rows[1:]:
        out += '\n' + pad + line
    return out
