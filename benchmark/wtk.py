"""The WindToolKit (WTK) stand-in, written by the benchmark.

A frozen copy of ``chip_smoke.py``'s stand-in archive (its ``_wtk_sites``,
``_wtk_raw``, ``WTK_SCALE`` and ``WTK_MARGIN_DEG``), in the way
``terrain.py`` freezes the DEM generator: the same sites and seed give the
same values, whatever the script's copy later becomes.

- :func:`sites`: the sites, lat-major, on a lon/lat lattice of about
  ``spacing_km`` over the region and a margin wider than the pad the
  program's WTK reader scans, each moved off the lattice by up to a tenth
  of its spacing, from the seed;
- :func:`raw`: a layer's int32 values at (hours, sites), smooth in space
  and turning with the hour (the direction through every bearing in
  about two days), over the layer's ``scale_factor`` as in WTK;
- :func:`values`: the same values as the program reads them (raw over
  the scale, float64), for the plain reference, which never reads the
  file;
- :func:`write`: the archive of one year (every hour of it, every layer
  the ``Simulator``'s ``wtk_layers`` names) as one file;
- :func:`reader_module`: an ``h5py``-shaped module over such files, the
  only reader of them (the machine with the card has no ``h5py``):
  ``File(path, mode='r')`` as a context manager, iterating its dataset
  names, ``coordinates`` (n, 2) lat/lon, and time-major layers with a
  ``scale_factor`` attribute.

Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import types

import numpy as np

# the divisor of each layer kind's stored integers (WTK's scale_factor)
SCALE = {'windspeed': 100., 'winddirection': 100., 'pressure': 0.1,
         'temperature': 100., 'boundary_layer_height': 1.,
         'surface_heat_flux': 1.}
# the lon/lat margin of sites around the region (the reader scans 0.02)
MARGIN_DEG = 0.06
# the file: a header of this many bytes (magic, JSON), then the arrays
HEADER_BYTES = 4096
MAGIC = b'ssrs-wtk-standin 1\n'
# hours written at a time
HOUR_BLOCK = 24 * 61


def layer_names(cfg: dict) -> list:
    """The six layers of the ``Simulator``'s ``wtk_layers`` for the
    configuration's WTK heights, in its order."""
    oro = int(cfg['wtk_orographic_height'])
    therm = int(cfg['wtk_thermal_height'])
    return [f'windspeed_{oro}m', f'winddirection_{oro}m',
            f'pressure_{therm}m', f'temperature_{therm}m',
            'boundary_layer_height', 'surface_heat_flux']


def scale_of(name: str) -> float:
    """The ``scale_factor`` of a layer name (its kind, before ``_<n>m``)."""
    kind = name if name in SCALE else name.rsplit('_', 1)[0]
    return SCALE[kind]


def year_hours(year: int) -> int:
    return 24 * (366 if year % 4 == 0 else 365)


def sites(lonlat_bounds, spacing_km: float, seed: int):
    """(lat, lon) float64 of the sites, lat-major: a lattice of about
    ``spacing_km`` over ``lonlat_bounds`` (west, south, east, north) and
    :data:`MARGIN_DEG`, each site moved off the lattice by up to a tenth
    of its spacing (WTK's projected grid is not a lattice in lon/lat
    either, and four sites on a circle have two triangulations)."""
    lon0, lat0, lon1, lat1 = lonlat_bounds
    mid = math.radians((lat0 + lat1) / 2)
    dlat = spacing_km / 111.2
    dlon = dlat / math.cos(mid)
    lats = np.arange(lat0 - MARGIN_DEG, lat1 + MARGIN_DEG, dlat)
    lons = np.arange(lon0 - MARGIN_DEG, lon1 + MARGIN_DEG, dlon)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    rng = np.random.default_rng(seed)
    lat_g = lat_g + rng.uniform(-0.1, 0.1, lat_g.shape) * dlat
    lon_g = lon_g + rng.uniform(-0.1, 0.1, lon_g.shape) * dlon
    return lat_g.ravel(), lon_g.ravel()


def raw(name: str, hours, lat, lon) -> np.ndarray:
    """The int32 values of one layer at ``hours`` (hours since Jan 1, any
    shape that broadcasts against the sites): speeds of 4-14 m/s, a
    direction that turns by ~110 degrees over the README region and by 7
    degrees an hour, times the layer's scale."""
    h = np.asarray(hours, np.float64)
    x, y = (lon + 106.) / 0.8, (lat - 42.8) / 0.5
    if name.startswith('windspeed'):
        val = 9. + 5. * np.sin(0.37 * h + 2.1 * x + 1.3 * y)
    elif name.startswith('winddirection'):
        val = np.mod(235. + 7. * h + 70. * x + 40. * y, 360.)
    elif name.startswith('pressure'):
        val = 85000. + 400. * np.sin(0.05 * h) - 900. * y
    elif name.startswith('temperature'):
        val = 12. + 9. * np.sin(2 * math.pi * (h % 24 - 9) / 24) - 2. * y
    elif name == 'boundary_layer_height':
        val = 900. + 600. * np.sin(2 * math.pi * (h % 24 - 8) / 24) ** 2 \
            + 0. * x
    else:
        val = 150. + 120. * np.sin(2 * math.pi * (h % 24 - 7) / 24) + 0. * x
    return np.round(val * scale_of(name)).astype(np.int32)


def values(name: str, hour: int, lat, lon) -> np.ndarray:
    """A layer at one hour as the program reads it: the stored integers
    over the ``scale_factor``, float64."""
    return raw(name, hour, lat, lon) / np.float64(scale_of(name))


def write(path: str, lat, lon, hours: int, names) -> None:
    """The archive of ``hours`` hours of the layers ``names`` at the sites
    (lat, lon): a header (:data:`MAGIC`, then JSON of each array's offset,
    shape and dtype and each layer's ``scale_factor``), the coordinates
    (n, 2) float64 lat/lon, then each layer (hours, n) int32."""
    n = len(lat)
    offset = HEADER_BYTES
    arrays = {'coordinates': {'offset': offset, 'shape': [n, 2],
                              'dtype': '<f8'}}
    offset += n * 2 * 8
    for name in names:
        arrays[name] = {'offset': offset, 'shape': [hours, n],
                        'dtype': '<i4', 'scale_factor': scale_of(name)}
        offset += hours * n * 4
    head = MAGIC + json.dumps(arrays).encode() + b'\n'
    if len(head) > HEADER_BYTES:
        raise ValueError('too many layers for the stand-in\'s header')
    tmp = path + '.part'
    with open(tmp, 'wb') as fobj:
        fobj.write(head.ljust(HEADER_BYTES, b' '))
        fobj.write(np.stack([lat, lon], axis=1).astype('<f8').tobytes())
        for name in names:
            for h0 in range(0, hours, HOUR_BLOCK):
                span = np.arange(h0, min(h0 + HOUR_BLOCK, hours))
                fobj.write(raw(name, span[:, None], lat, lon)
                           .astype('<i4').tobytes())
    os.replace(tmp, path)


class _Dataset:
    """One array of a stand-in file: numpy indexing (a copy) and
    ``attrs``."""

    def __init__(self, array, attrs):
        self._array = array
        self.attrs = attrs

    def __getitem__(self, key):
        return np.array(self._array[key])


class _File:
    """A stand-in file opened read-only, as ``h5py.File``."""

    def __init__(self, path, mode='r', **kwargs):
        if mode != 'r':
            raise ValueError('the WTK stand-in opens read-only')
        with open(path, 'rb') as fobj:
            head = fobj.read(HEADER_BYTES)
        if not head.startswith(MAGIC):
            raise OSError(f'{path} is not a WTK stand-in')
        meta = json.loads(head[len(MAGIC):].split(b'\n', 1)[0])
        self._sets = {}
        for name, m in meta.items():
            array = np.memmap(path, dtype=m['dtype'], mode='r',
                              offset=m['offset'], shape=tuple(m['shape']))
            attrs = {'scale_factor': np.float64(m['scale_factor'])} \
                if 'scale_factor' in m else {}
            self._sets[name] = _Dataset(array, attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        self._sets = {}

    def __iter__(self):
        return iter(list(self._sets))

    def __getitem__(self, name):
        return self._sets[name]


def reader_module() -> types.ModuleType:
    """A module named ``h5py`` whose ``File`` opens stand-in files."""
    mod = types.ModuleType('h5py')
    mod.File = _File
    mod.__doc__ = 'The benchmark\'s reader of its WTK stand-in files.'
    return mod


@contextlib.contextmanager
def reader_installed():
    """``h5py`` is :func:`reader_module` while this is open (the program
    imports it by name when it opens a ``LOCAL`` source); the module that
    was there before, or none, after."""
    saved = sys.modules.get('h5py')
    sys.modules['h5py'] = reader_module()
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop('h5py', None)
        else:
            sys.modules['h5py'] = saved
