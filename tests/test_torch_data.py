"""The port's data sources against the JAX package's, offline.

The same inputs go through ``ssrs_tpu.data`` / ``ssrs_tpu.utils`` and
their counterparts in ``ssrs_tpu_torch``: the column table that stands in
for pandas (CSV files written by either read by the other, exactly), the
solar and seasonal helpers (exactly), the WMS / 3DEP / SRTM clients
through the replayed HTTP transcripts of ``http_replay.py`` (byte-equal
GeoTIFFs, the same exceptions), the USWTDB client (the same rows,
reprojected coordinates within 1e-6 m), and the WTK client on an h5py
fixture (``LOCAL``) and an h5pyd-shaped stub (``AWS``): locations, time
index, values, cache invalidation, parallel download, exactly.
"""

import io
import json
import os
import subprocess
import sys
from datetime import date, datetime

import numpy as np
import pytest
import requests

from http_replay import (FakeResponse, FakeWMSServer, ReplayTransport,
                         analytic_elevation, fixture_bytes, make_hsds_stub)

import ssrs_tpu.data as jdata
import ssrs_tpu.utils as jutils
import ssrs_tpu_torch.data as tdata
import ssrs_tpu_torch.utils as tutils
from ssrs_tpu_torch.data import Table, read_csv
from ssrs_tpu_torch.data.table import EmptyDataError
from ssrs_tpu_torch.data.turbines import records_to_table
from ssrs_tpu_torch.data.wms import WMSError

pd = pytest.importorskip('pandas')
h5py = pytest.importorskip('h5py')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = FakeResponse(200, fixture_bytes('threedep_getcapabilities.xml'),
                    'text/xml')
SERVICE_EXC = FakeResponse(
    200, fixture_bytes('wms_service_exception.xml'),
    'application/vnd.ogc.se_xml')
YEAR = 2012
LAYERS = ['windspeed_100m', 'winddirection_100m', 'pressure_100m',
          'temperature_100m', 'boundary_layer_height',
          'surface_heat_flux']
WTK_BOUNDS = (-106.6, 42.4, -105.4, 43.4)


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(autouse=True)
def _no_retry_sleep(monkeypatch):
    import ssrs_tpu_torch.data.wms as wms_mod
    monkeypatch.setattr(wms_mod.time, 'sleep', lambda s: None)


# ---- the table against pandas -----------------------------------------------

def _frames():
    """name -> (pandas frame, the same as a Table): the three kinds of
    frame the clients cache."""
    rng = np.random.default_rng(21)
    n = 57
    locs = dict(Indices=np.arange(1000, 1000 + n) * 3,
                Longitude=rng.uniform(-107, -105, n),
                Latitude=rng.uniform(42, 44, n))
    wtk = dict(locs)
    for name in LAYERS:
        wtk[name] = rng.integers(-500, 90000, n) / 10.0
    # floats that test the shortest round trip, and a NaN
    wtk['windspeed_100m'][:6] = [0.1, 1e-7, 1e16, 1 / 3, -0.0, np.nan]
    turb = dict(t_state=np.array(['WY', 'WY', 'CA', 'TX'], object),
                p_name=np.array(['Casper Wind Farm', 'A, quoted "name"',
                                 'Altamont', 'Panhandle'], object),
                p_year=np.array([2009, 2009, 2011, 2014]),
                t_hh=np.array([80.0, 65.5, 55.0, 95.0]),
                x=rng.uniform(-1e6, 1e6, 4), y=rng.uniform(-1e6, 1e6, 4))
    turb_index = np.array([3, 5, 17, 40])
    out = {'locations': (pd.DataFrame(locs), Table(locs)),
           'wtk': (pd.DataFrame(wtk), Table(wtk)),
           'turbines': (pd.DataFrame(turb, index=turb_index),
                        Table(turb, index=turb_index))}
    return out


def _same(table, frame, maxulp=0):
    """The table holds what the pandas frame holds: names, index, types
    and values, exactly (floats within ``maxulp``)."""
    assert table.columns == list(frame.columns)
    np.testing.assert_array_equal(table.index, frame.index.values)
    for name in table.columns:
        want = frame[name].to_numpy()
        got = table[name]
        # pandas holds strings in its own string type, the table as objects
        assert got.dtype == (want.dtype if want.dtype.kind in 'iufb'
                             else object), name
        if want.dtype.kind == 'f' and maxulp:
            keep = ~np.isnan(want)
            assert np.array_equal(np.isnan(got), ~keep), name
            np.testing.assert_array_max_ulp(got[keep], want[keep], maxulp)
        elif want.dtype.kind == 'f':
            np.testing.assert_array_equal(got, want)  # NaN equals NaN
        else:
            assert list(got) == list(want), name


@pytest.mark.parametrize('kind', ['locations', 'wtk', 'turbines'])
def test_table_csv_written_by_port_read_by_pandas(tmp_path, kind):
    """Exactly, with pandas' round-trip float parser; its default parser
    is not exact on 17-digit fields (it reads its own files one ulp off
    too), so there the bound is one ulp."""
    frame, table = _frames()[kind]
    fpath = str(tmp_path / 'port.csv')
    table.to_csv(fpath)
    pd.testing.assert_frame_equal(
        pd.read_csv(fpath, index_col=0, float_precision='round_trip'),
        frame, check_exact=True)
    _same(table, pd.read_csv(fpath, index_col=0), maxulp=1)


@pytest.mark.parametrize('kind', ['locations', 'wtk', 'turbines'])
def test_table_csv_written_by_pandas_read_by_port(tmp_path, kind):
    frame, table = _frames()[kind]
    fpath = str(tmp_path / 'pandas.csv')
    frame.to_csv(fpath)
    back = read_csv(fpath)
    _same(back, frame)
    assert back.equals(table)


@pytest.mark.parametrize('kind', ['locations', 'wtk', 'turbines'])
def test_table_csv_bytes_equal_pandas(tmp_path, kind):
    frame, table = _frames()[kind]
    table.to_csv(str(tmp_path / 'a.csv'))
    frame.to_csv(str(tmp_path / 'b.csv'))
    assert (tmp_path / 'a.csv').read_bytes() == \
        (tmp_path / 'b.csv').read_bytes()


@pytest.mark.parametrize('ascending', [True, False])
def test_table_sort_values_as_pandas(ascending):
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 6, 40).astype(float)   # many ties
    vals[[3, 11]] = np.nan
    cols = dict(key=vals, tag=np.arange(40))
    want = pd.DataFrame(cols).sort_values('key', ascending=ascending)
    _same(Table(cols).sort_values('key', ascending=ascending), want)


def test_table_select_assign_equals():
    frame, table = _frames()['turbines']
    mask = np.array([True, False, True, True])
    _same(table.select(mask), frame.loc[mask, :])
    grown = table.assign(presence=np.arange(4) / 4)
    _same(grown, frame.assign(presence=np.arange(4) / 4))
    assert 'presence' not in table and 'presence' in grown
    assert len(grown.columns) == 7 and len(grown) == 4 and not grown.empty
    assert table.column_equals('t_hh', grown)
    other = table.copy()
    other['t_hh'] = table['t_hh'] + 1.
    assert not table.column_equals('t_hh', other)
    assert not table.equals(other) and table.equals(table.copy())
    # an int column never equals its float copy, as Series.equals
    other['p_year'] = table['p_year'].astype(float)
    assert not table.column_equals('p_year', other)
    with pytest.raises(ValueError):
        table['short'] = np.arange(3)
    with pytest.raises(ValueError):
        Table(dict(a=np.arange(3), b=np.arange(4)))
    assert Table.from_any(table) is table
    assert Table.from_any(dict(a=[1, 2])).columns == ['a']


def test_table_read_csv_empty(tmp_path):
    (tmp_path / 'none.csv').write_text('')
    with pytest.raises(EmptyDataError):
        read_csv(str(tmp_path / 'none.csv'))
    with pytest.raises(pd.errors.EmptyDataError):
        pd.read_csv(str(tmp_path / 'none.csv'), index_col=0)
    Table(dict(Indices=np.zeros(0, int))).to_csv(str(tmp_path / 'e.csv'))
    assert read_csv(str(tmp_path / 'e.csv')).empty
    assert pd.read_csv(str(tmp_path / 'e.csv'), index_col=0).empty
    with pytest.raises(FileNotFoundError):
        read_csv(str(tmp_path / 'missing.csv'))


def test_records_to_table_as_pandas_read_json():
    raw = fixture_bytes('uswtdb_turbines.json')
    _same(records_to_table(json.loads(raw)), pd.read_json(io.BytesIO(raw)))
    with_null = [dict(a=1, b='x', c=1.5), dict(a=2, b=None, c=None)]
    got = records_to_table(with_null)
    assert got['a'].dtype == np.int64 and got['c'].dtype == np.float64
    assert np.isnan(got['c'][1]) and got['b'][0] == 'x'
    for bad in ({'message': 'no'}, [1, 2], 'text'):
        with pytest.raises(ValueError):
            records_to_table(bad)


# ---- solar and seasonal helpers ---------------------------------------------

_LONLATS = [(-121.98, 37.56), (-79.7, 39.), (-106.21, 42.78),
            (-112.07, 33.45), (-40., 45.)]
_DATES = [date(2010, 6, 21), date(2010, 1, 15), date(2012, 12, 20),
          date(2012, 3, 11)]


@pytest.mark.parametrize('lonlat', _LONLATS)
def test_solar_helpers_equal_jax(lonlat):
    lon, lat = lonlat
    assert tutils.conus_timezone_name(lon, lat) == \
        jutils.conus_timezone_name(lon, lat)
    for day in _DATES:
        assert tutils.utc_offset_hours(lon, lat, day) == \
            jutils.utc_offset_hours(lon, lat, day)
        assert tutils.get_sunrise_sunset_time(lonlat, day) == \
            jutils.get_sunrise_sunset_time(lonlat, day)
        assert tutils._solar_noon_and_halfday(lon, lat, day) == \
            jutils._solar_noon_and_halfday(lon, lat, day)
    with pytest.raises(ValueError):
        tutils.get_sunrise_sunset_time(lonlat, 'not-a-date')


@pytest.mark.parametrize('tod', ['morning', 'afternoon', 'evening',
                                 'daytime'])
def test_seasonal_datetimes_equal_jax(tod):
    args = ([2010, 2012], (3, 20), (5, 15), tod, 12, (-106.21, 42.78))
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    got = tutils.get_seasonal_datetimes_list(*args, rng_t)
    want = jutils.get_seasonal_datetimes_list(*args, rng_j)
    assert got == want and len(set(got)) == 12
    # and the generator is left where the JAX package's is
    assert rng_t.random() == rng_j.random()


def test_seasonal_datetimes_invalid_timeofday():
    with pytest.raises(ValueError, match='Invalid time of day'):
        tutils.get_seasonal_datetimes_list(
            [2012], (6, 1), (6, 30), 'midnight', 2, (-106.21, 42.78),
            np.random.default_rng(0))


# ---- WMS / 3DEP / SRTM through replayed transcripts -------------------------

def _wms_pair(tmp_path, monkeypatch, make, run):
    """Run the same download through each package's client; returns the
    two GeoTIFFs' bytes and the port's transport."""
    out = {}
    for name, mod in (('jax', jdata), ('port', tdata)):
        transport = ReplayTransport().install(monkeypatch)
        transport.add('GetCapabilities', CAPS)
        transport.add('GetMap', FakeWMSServer(tmp_path))
        fpath = str(tmp_path / f'{name}.tif')
        run(make(mod, fpath), fpath)
        with open(fpath, 'rb') as fobj:
            out[name] = fobj.read()
    return out['jax'], out['port'], transport


def test_threedep_download_equals_jax(tmp_path, monkeypatch):
    bnds = (-106.2, 42.8, -106.1, 42.9)
    res = 1. / 1200.
    jbytes, tbytes, transport = _wms_pair(
        tmp_path, monkeypatch,
        lambda mod, fpath: mod.ThreeDEP('DEM', bnds, fpath, res=res),
        lambda client, fpath: client.download())
    assert tbytes == jbytes
    info = tdata.read_geotiff(str(tmp_path / 'port.tif'))
    lon = bnds[0] + (np.arange(120) + 0.5) * res
    lat = bnds[3] - (np.arange(120) + 0.5) * res  # row 0 = north
    np.testing.assert_allclose(
        info.data, analytic_elevation(lon[None, :], lat[:, None]),
        atol=1e-2)
    np.testing.assert_allclose(info.bounds, bnds, atol=1e-9)
    (_, caps_params), (_, map_params) = transport.requests[:2]
    assert caps_params['request'] == 'GetCapabilities'
    assert map_params['layers'] == '3DEPElevation:None'
    assert [float(v) for v in map_params['bbox'].split(',')] == [
        bnds[1], bnds[0], bnds[3], bnds[2]]


def test_wms_multi_tile_mosaic_equals_jax(tmp_path, monkeypatch):
    bnds = (-106.2, 42.8, -106.1, 42.9)
    jbytes, tbytes, transport = _wms_pair(
        tmp_path, monkeypatch,
        lambda mod, fpath: mod.WMS(bnds, 'EPSG:4326', mod.ThreeDEP.wms_url,
                                   max_gridsize=50),
        lambda wms, fpath: wms.download_raster('3DEPElevation:None',
                                               1. / 1200., fpath))
    assert tbytes == jbytes
    assert transport.count('GetMap') == 9


def test_threedep_layer_names_and_urls_equal_jax():
    assert tdata.ThreeDEP.valid_layers == jdata.ThreeDEP.valid_layers
    assert tdata.ThreeDEP.wms_url == jdata.ThreeDEP.wms_url
    assert tdata.SRTM.tile_url == jdata.SRTM.tile_url
    assert tdata.TurbinesUSWTB.url == jdata.TurbinesUSWTB.url
    client = tdata.ThreeDEP('Slope Degrees', (0., 0., 1., 1.), 'x.tif')
    assert client.layer_name == '3DEPElevation:Slope Degrees'
    with pytest.raises(ValueError, match='not a valid layer'):
        tdata.ThreeDEP('Nope', (0., 0., 1., 1.), 'x.tif')


def _small_client():
    return tdata.WMS((-106.2, 42.8, -106.15, 42.85), 'EPSG:4326',
                     tdata.ThreeDEP.wms_url, max_gridsize=200,
                     max_retries=3)


def test_getmap_retry_then_succeed(tmp_path, monkeypatch):
    transport = ReplayTransport().install(monkeypatch)
    transport.add('GetCapabilities', CAPS)
    transport.add('GetMap', [FakeResponse(500), FakeResponse(503),
                             FakeWMSServer(tmp_path)])
    fpath = str(tmp_path / 'out.tif')
    _small_client().download_raster('3DEPElevation:None', 1. / 1200., fpath)
    assert transport.count('GetMap') == 3
    assert os.path.exists(fpath)


@pytest.mark.parametrize('responder,match,n_getmap', [
    (FakeResponse(500), 'gave up after 4 attempts', 4),
    (SERVICE_EXC, 'gave up', 4),
    (requests.exceptions.ConnectionError('no route to host'), 'gave up', 1),
], ids=['http-500', 'service-exception', 'connection-error'])
def test_getmap_failures_raise_wmserror(monkeypatch, tmp_path, responder,
                                        match, n_getmap):
    """Retry exhaustion, an OGC ServiceExceptionReport with HTTP 200, and
    an unreachable host (which does not burn the retry budget)."""
    transport = ReplayTransport().install(monkeypatch)
    transport.add('GetCapabilities', CAPS)
    transport.add('GetMap', responder)
    with pytest.raises(WMSError, match=match):
        _small_client().download_raster('3DEPElevation:None', 1. / 1200.,
                                        str(tmp_path / 'out.tif'))
    assert transport.count('GetMap') == n_getmap
    assert not os.path.exists(tmp_path / 'out.tif')


def test_getmap_malformed_tiff_surfaces(monkeypatch, tmp_path):
    transport = ReplayTransport().install(monkeypatch)
    transport.add('GetCapabilities', CAPS)
    transport.add('GetMap', FakeResponse(200, b'NOT A TIFF', 'image/tiff'))
    with pytest.raises(Exception):
        _small_client().download_raster('3DEPElevation:None', 1. / 1200.,
                                        str(tmp_path / 'out.tif'))
    assert not os.path.exists(tmp_path / 'out.tif')


def test_capabilities_validation(monkeypatch):
    transport = ReplayTransport().install(monkeypatch)
    transport.add('GetCapabilities', CAPS)
    wms = _small_client()
    wms.validate_layer('3DEPElevation:Slope Degrees')  # inherited CRS ok
    jwms = jdata.WMS((-106.2, 42.8, -106.15, 42.85), 'EPSG:4326',
                     jdata.ThreeDEP.wms_url)
    assert wms._capabilities == jwms._fetch_capabilities()
    with pytest.raises(ValueError, match='not advertised'):
        wms.validate_layer('3DEPElevation:Nope')
    bad_crs = tdata.WMS((-106.2, 42.8, -106.15, 42.85), 'EPSG:32613',
                        tdata.ThreeDEP.wms_url)
    bad_crs._capabilities = wms._capabilities
    with pytest.raises(ValueError, match='does not support CRS'):
        bad_crs.validate_layer('3DEPElevation:None')


def test_capabilities_fetch_failure_is_wmserror(monkeypatch):
    transport = ReplayTransport().install(monkeypatch)
    transport.add('GetCapabilities', FakeResponse(500))
    with pytest.raises(WMSError, match='GetCapabilities'):
        _small_client().validate_layer('3DEPElevation:None')


def test_wms_geometry_and_argument_checks():
    wms = tdata.WMS((1., 2., 3., 4.), 'EPSG:4326', 'http://example.invalid')
    assert wms._bbox_param((1., 2., 3., 4.)) == '2.0,1.0,4.0,3.0'
    wms.version = '1.1.1'
    assert wms._bbox_param((1., 2., 3., 4.)) == '1.0,2.0,3.0,4.0'
    jwms = jdata.WMS((1., 2., 3., 4.), 'EPSG:4326', 'http://example.invalid',
                     max_gridsize=70)
    wms.max_gridsize = 70
    assert wms.segment_region_into_tiles(0.01) == \
        jwms.segment_region_into_tiles(0.01)
    with pytest.raises(ValueError, match='Invalid resolution'):
        wms.download_raster('layer', 5.0, 'x.tif')
    with pytest.raises(ValueError, match='Invalid bounds'):
        tdata.WMS((1., 1., 0., 0.), 'EPSG:4326', 'http://example.invalid')


def test_srtm_stitch_and_clip_equals_jax(tmp_path, monkeypatch):
    n_px = 61  # small fake tiles (real SRTM1 is 3601)

    def fake_tile(self, lat, lon):
        yy, xx = np.mgrid[0:n_px, 0:n_px]
        return (lat * 1000. + lon + yy * 0.25 + xx * 0.5).astype(np.float32)

    bnds = (-106.7, 42.2, -105.4, 43.6)  # spans 2x2 tiles
    raw = {}
    for name, mod in (('jax', jdata), ('port', tdata)):
        monkeypatch.setattr(mod.SRTM, '_tile', fake_tile)
        fpath = str(tmp_path / f'{name}.tif')
        mod.SRTM('SRTM1', bnds, fpath).download()
        raw[name] = open(fpath, 'rb').read()
    assert raw['port'] == raw['jax']
    info = tdata.read_geotiff(str(tmp_path / 'port.tif'))
    assert info.bounds[0] <= bnds[0] and info.bounds[2] >= bnds[2]
    assert info.bounds[1] <= bnds[1] and info.bounds[3] >= bnds[3]


def test_srtm_errors(tmp_path):
    from ssrs_tpu_torch.data.srtm import SRTMError
    with pytest.raises(ValueError, match='invalid layer'):
        tdata.SRTM('SRTM9', (0., 0., 1., 1.), str(tmp_path / 'x.tif'))
    with pytest.raises(ValueError, match='northing and easting'):
        tdata.SRTM('SRTM1', (1., 1., 0., 0.), str(tmp_path / 'x.tif'))
    # the module's fixture refuses the tile request
    with pytest.raises(SRTMError, match='something went wrong'):
        tdata.SRTM('SRTM1', (-106.7, 42.2, -106.4, 42.6),
                   str(tmp_path / 'x.tif')).download()


# ---- Terrain ----------------------------------------------------------------

def test_terrain_layers_and_unknown_layer(tmp_path):
    assert tdata.Terrain.valid_layers == jdata.Terrain.valid_layers
    bounds = (-106.2, 42.8, -106.1, 42.9)
    msgs = []
    for mod in (jdata, tdata):
        region = mod.Terrain(bounds, str(tmp_path))
        with pytest.raises(ValueError, match='Invalid layer name') as err:
            region.download('Moon Dust')
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_terrain_dispatch_and_cache(tmp_path, monkeypatch):
    """DEM goes to 3DEP, SRTM1 to SRTM, SYNTHETIC to the synthetic source;
    a cached file that holds the bounds is not fetched again, and the
    rasters equal the JAX package's byte for byte."""
    bounds = (-106.2, 42.8, -106.1, 42.9)

    def fake_tile(self, lat, lon):
        return np.full((61, 61), lat * 1000. + lon, np.float32)

    raw = {}
    for name, mod in (('jax', jdata), ('port', tdata)):
        transport = ReplayTransport().install(monkeypatch)
        transport.add('GetCapabilities', CAPS)
        transport.add('GetMap', FakeWMSServer(tmp_path))
        monkeypatch.setattr(mod.SRTM, '_tile', fake_tile)
        monkeypatch.setattr(mod.ThreeDEP, '__init__', _coarse_init(mod))
        region = mod.Terrain(bounds, str(tmp_path / name))
        region.download(['DEM', 'Slope Degrees', 'SRTM1', 'SYNTHETIC'])
        n_requests = len(transport.requests)
        assert transport.count('GetMap') == 2
        region.download(['DEM', 'Slope Degrees', 'SRTM1', 'SYNTHETIC'])
        assert len(transport.requests) == n_requests
        raw[name] = {
            lyr: open(region.get_raster_fpath(lyr), 'rb').read()
            for lyr in ('DEM', 'Slope Degrees', 'SRTM1', 'SYNTHETIC')}
    assert sorted(os.listdir(tmp_path / 'port')) == \
        ['dem.tif', 'slope_degrees.tif', 'srtm1.tif', 'synthetic.tif']
    for lyr, data in raw['port'].items():
        assert data == raw['jax'][lyr], lyr
    # a region the cached file does not hold is fetched anew
    with pytest.raises(FileNotFoundError):
        tdata.Terrain((-106.3, 42.8, -106.1, 42.9), str(
            tmp_path / 'port')).validate_saved_layer_data('DEM')


def _coarse_init(mod):
    """ThreeDEP at 3 arcsec instead of 1/3, so that the fake server's
    tiles stay small."""
    real = mod.ThreeDEP.__init__

    def init(self, layer, bnds, fpath, res=1. / 1200.):
        real(self, layer, bnds, fpath, res=res)
    return init


# ---- USWTDB -----------------------------------------------------------------

def _uswtdb(monkeypatch, responder):
    transport = ReplayTransport().install(monkeypatch)
    transport.add(lambda url, params: 'uswtdb' in url, responder)
    return transport


USWTDB_OK = FakeResponse(200, fixture_bytes('uswtdb_turbines.json'),
                         'application/json')


def test_uswtdb_rows_equal_jax_and_csv_crosses(monkeypatch, tmp_path,
                                                capsys):
    _uswtdb(monkeypatch, USWTDB_OK)
    kwargs = dict(bounds=(-106.25, 42.75, -106.0, 43.0), min_hubheight=50.)
    jt = jdata.TurbinesUSWTB(out_fpath=str(tmp_path / 'j.csv'), **kwargs)
    tt = tdata.TurbinesUSWTB(out_fpath=str(tmp_path / 't.csv'), **kwargs)
    _same(tt.dframe, jt.dframe)
    assert len(tt.dframe) == 3
    assert list(tt.get_project_names()) == ['Casper Wind Farm'] == \
        list(jt.get_project_names())
    for got, want in zip(tt.get_locations(), jt.get_locations()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            tt.get_locations_for_this_project('Casper Wind Farm'),
            jt.get_locations_for_this_project('Casper Wind Farm')):
        np.testing.assert_array_equal(got, want)
    # turbines.csv: the same bytes, and each package reads the other's
    assert (tmp_path / 't.csv').read_bytes() == \
        (tmp_path / 'j.csv').read_bytes()
    _same(read_csv(str(tmp_path / 'j.csv')), jt.dframe)
    pd.testing.assert_frame_equal(
        pd.read_csv(str(tmp_path / 't.csv'), index_col=0,
                    float_precision='round_trip'), jt.dframe)
    capsys.readouterr()
    tt.print_details()
    got = capsys.readouterr().out
    jt.print_details()
    assert got == capsys.readouterr().out


def test_uswtdb_reprojects_as_jax(monkeypatch, tmp_path):
    _uswtdb(monkeypatch, USWTDB_OK)
    xmin, ymin = tdata.transform_coordinates('EPSG:4326', 'ESRI:102008',
                                             [-106.25], [42.75])
    xmax, ymax = tdata.transform_coordinates('EPSG:4326', 'ESRI:102008',
                                             [-105.8], [43.0])
    kwargs = dict(bounds=(float(xmin[0]), float(ymin[0]), float(xmax[0]),
                          float(ymax[0])),
                  crs_string='ESRI:102008', min_hubheight=50., out_fpath=None)
    jt, tt = jdata.TurbinesUSWTB(**kwargs), tdata.TurbinesUSWTB(**kwargs)
    assert tt.dframe.columns == list(jt.dframe.columns)
    assert len(tt.dframe) == len(jt.dframe) >= 3
    np.testing.assert_array_equal(tt.dframe.index, jt.dframe.index.values)
    for got, want in zip(tt.get_locations(), jt.get_locations()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('responder', [
    FakeResponse(500),
    FakeResponse(200, b'<html>service temporarily unavailable</html>',
                 'text/html'),
    FakeResponse(200, b'{"message": "no such table"}', 'application/json'),
    requests.exceptions.ConnectionError('no route to host'),
], ids=['http-500', 'html', 'json-object', 'connection-error'])
def test_uswtdb_failures_yield_none(monkeypatch, responder):
    _uswtdb(monkeypatch, responder)
    turbs = tdata.TurbinesUSWTB(bounds=(-106.25, 42.75, -106.0, 43.0),
                                out_fpath=None)
    assert turbs.dframe is None
    turbs.print_details()   # says that there are none; must not raise


def test_uswtdb_injected_dict_or_table(tmp_path):
    cols = dict(t_state=['WY'] * 3, p_name=['P1', 'P1', 'P2'],
                p_year=[2015] * 3, t_cap=[2000] * 3,
                t_hh=[90., 40., 90.], t_rd=[100.] * 3,
                xlong=[-106.18, -106.15, -100.], ylat=[42.80, 42.81, 42.8])
    bounds = (-106.25, 42.75, -106.0, 43.0)
    want = jdata.TurbinesUSWTB(bounds, out_fpath=None,
                               dataframe=pd.DataFrame(cols)).dframe
    for given in (cols, Table(cols)):
        got = tdata.TurbinesUSWTB(bounds, out_fpath=None, dataframe=given)
        _same(got.dframe, want)
        assert len(got.dframe) == 1


# ---- WTK --------------------------------------------------------------------

@pytest.fixture(scope='module')
def wtk_h5(tmp_path_factory):
    """A WTK-shaped archive: a lon/lat lattice over WY with hourly values
    for 2012 (coordinates, (time, site) int32 datasets with scale_factor
    attributes)."""
    d = tmp_path_factory.mktemp('wtk')
    fpath = str(d / f'wtk_fixture_{YEAR}.h5')
    rng = np.random.default_rng(7)
    lats = np.linspace(42.0, 43.8, 40)
    lons = np.linspace(-107.0, -105.0, 25)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
    with h5py.File(fpath, 'w') as f:
        f.create_dataset('coordinates', data=coords)
        for name in LAYERS:
            base = rng.uniform(2, 15) if 'speed' in name else \
                rng.uniform(0, 360) if 'direction' in name else \
                rng.uniform(80000, 90000) if 'pressure' in name else \
                rng.uniform(0, 25)
            vals = base + rng.standard_normal((24 * 366, coords.shape[0]))
            ds = f.create_dataset(name, data=(vals * 10.).astype('i4'))
            ds.attrs['scale_factor'] = 10.0
    return fpath


def _wtk(mod, wtk_h5, out_dir, bounds=WTK_BOUNDS, layers=LAYERS):
    return mod.WTK('LOCAL', bounds, layers, str(out_dir),
                   local_template=wtk_h5.replace(str(YEAR), '$YEAR'),
                   local_years=[YEAR])


def test_wtk_locations_equal_jax(wtk_h5, tmp_path):
    jw, tw = _wtk(jdata, wtk_h5, tmp_path / 'j'), \
        _wtk(tdata, wtk_h5, tmp_path / 't')
    assert tw.years == jw.years and tw.file_names == jw.file_names
    assert tw.valid_layers == jw.valid_layers
    assert set(tw.varnames) == jw.varnames and tw.varnames == LAYERS
    assert tw.lonlat_bounds == jw.lonlat_bounds
    want = jw.get_locations()
    # the JAX package's coordinates come back through pandas' default float
    # parser, one ulp off on some; the port's are the archive's, exactly
    _same(tw.get_locations(), want, maxulp=1)
    got = tw.get_locations()
    with h5py.File(wtk_h5, 'r') as f:
        np.testing.assert_array_equal(
            np.stack([got['Latitude'], got['Longitude']], axis=1),
            f['coordinates'][:][got['Indices']])
    assert len(want) > 0
    for name in ('wtk_locations.csv', 'wtk_locations_bounds.json'):
        assert (tmp_path / 't' / name).read_bytes() == \
            (tmp_path / 'j' / name).read_bytes()
    for got, ref in zip(tw.get_coordinates(), jw.get_coordinates()):
        np.testing.assert_array_max_ulp(got, ref, 1)


@pytest.mark.parametrize('when', [datetime(YEAR, 1, 1, 0),
                                  datetime(YEAR, 6, 17, 13),
                                  datetime(YEAR, 12, 31, 23)])
def test_wtk_values_and_time_index_equal_jax(wtk_h5, tmp_path, when):
    jw, tw = _wtk(jdata, wtk_h5, tmp_path / 'j'), \
        _wtk(tdata, wtk_h5, tmp_path / 't')
    want = jw.download_data_for_this_time(when)
    got = tw.download_data_for_this_time(when)
    assert got.columns[:3] == ['Indices', 'Longitude', 'Latitude']
    assert sorted(got.columns) == sorted(want.columns)
    _same(got, want[got.columns], maxulp=1)
    tidx = (when - datetime(YEAR, 1, 1)).days * 24 + when.hour
    with h5py.File(wtk_h5, 'r') as f:
        for name in LAYERS:
            raw = f[name][tidx, got['Indices']] / 10.0
            np.testing.assert_array_equal(got[name], raw)
            np.testing.assert_array_equal(want[name].to_numpy(), raw)
    assert tw.get_filename(when) == jw.get_filename(when)
    # the port's cached frame reads back exactly
    assert tw.get_dataframe_for_this_time(when).equals(got)


def test_wtk_caches_cross_between_packages(wtk_h5, tmp_path):
    """A cache written by one package serves the other: no fetch, equal
    values, both ways."""
    when = datetime(YEAR, 6, 17, 13)
    for writer, reader, name in ((jdata, tdata, 'j2t'),
                                 (tdata, jdata, 't2j')):
        wrote = _wtk(writer, wtk_h5, tmp_path / name)
        frame = wrote.download_data_for_this_time(when)
        fpaths = [tmp_path / name / f for f in
                  ('wtk_locations.csv', wrote.get_filename(when))]
        mtimes = [os.stat(f).st_mtime_ns for f in fpaths]
        other = _wtk(reader, wtk_h5, tmp_path / name)

        def refuse(*args, **kwargs):
            raise AssertionError('fetched although the cache is usable')
        other.download_data_for_this_time = refuse
        other.download_locations = refuse
        back = other.get_dataframe_for_this_time(when)
        assert [os.stat(f).st_mtime_ns for f in fpaths] == mtimes
        if reader is tdata:
            _same(back, pd.read_csv(fpaths[1], index_col=0,
                                    float_precision='round_trip')[
                                        back.columns])
            _same(back, frame[back.columns], maxulp=1)
        else:
            # pandas' default float parser may read a field one ulp off
            _same(frame, back[frame.columns], maxulp=1)
            _same(frame, pd.read_csv(fpaths[1], index_col=0,
                                     float_precision='round_trip')[
                                         frame.columns])


def test_wtk_cache_invalidated_on_new_bounds(wtk_h5, tmp_path):
    wtk_a = _wtk(tdata, wtk_h5, tmp_path)
    df_a = wtk_a.get_locations()
    when = datetime(YEAR, 6, 17, 13)
    wtk_a.download_data_for_this_time(when)
    shifted = (-105.9, 42.9, -105.2, 43.2)
    wtk_b = _wtk(tdata, wtk_h5, tmp_path, bounds=shifted)
    df_b = wtk_b.get_locations()
    _same(df_b, _wtk(jdata, wtk_h5, tmp_path / 'j',
                     bounds=shifted).get_locations(), maxulp=1)
    assert (df_b['Longitude'] > -106.0).all()
    assert (df_b['Latitude'] > 42.8).all() and len(df_b) < len(df_a)
    # the old timestamp's frame holds the old stations: fetched anew
    frame = wtk_b.get_dataframe_for_this_time(when)
    assert frame.column_equals('Indices', df_b)
    # a warm re-read with unchanged bounds does not re-scan
    fpath = os.path.join(str(tmp_path), 'wtk_locations.csv')
    mtime = os.path.getmtime(fpath)
    wtk_b.get_locations()
    assert os.path.getmtime(fpath) == mtime


def test_wtk_parallel_download_and_rerun_reads_nothing(wtk_h5, tmp_path):
    tw = _wtk(tdata, wtk_h5, tmp_path / 't')
    jw = _wtk(jdata, wtk_h5, tmp_path / 'j')
    times = [datetime(YEAR, 5, 1, h) for h in (9, 12, 15, 18)]
    tw.download_data(times, max_cores=4)
    jw.download_data(times, max_cores=1)
    for t in times:
        got = read_csv(os.path.join(tw.out_dir, tw.get_filename(t)))
        want = pd.read_csv(os.path.join(jw.out_dir, jw.get_filename(t)),
                           index_col=0)
        _same(got, want[got.columns], maxulp=1)
    # a second download of cached timestamps opens no file of the source
    opened = []
    real = tw.hsds

    class Counting:
        @staticmethod
        def File(*args, **kwargs):
            opened.append(args)
            return real.File(*args, **kwargs)
    tw.hsds = Counting
    tw.download_data(times + [datetime(YEAR, 5, 2, 9)], max_cores=4)
    assert len(opened) == 1


def test_wtk_argument_errors(wtk_h5, tmp_path):
    tw = _wtk(tdata, wtk_h5, tmp_path)
    with pytest.raises(ValueError, match='outside this'):
        tw.download_data_for_this_time(datetime(1999, 1, 1, 0))
    with pytest.raises(ValueError, match='datetime.datetime'):
        tw.download_data_for_this_time('2012-01-01')
    with pytest.raises(ValueError, match='none of the requested layers'):
        _wtk(tdata, wtk_h5, tmp_path, layers=['windspeed_9m'])
    with pytest.raises(ValueError, match='Unknown WindToolKit source'):
        tdata.WtkSource('MOON')
    with pytest.raises(ValueError, match='local_template'):
        tdata.WtkSource('LOCAL')
    with pytest.raises(FileNotFoundError, match='could not open'):
        tdata.WtkSource('LOCAL', local_template=str(tmp_path / 'no_$YEAR.h5'),
                        local_years=[YEAR])
    assert tdata.WtkSource.valid_sources == jdata.WtkSource.valid_sources


def _hsds_fixture():
    lats = np.linspace(42.0, 43.5, 15)
    lons = np.linspace(-107.0, -105.5, 10)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
    n = coords.shape[0]
    rng = np.random.default_rng(7)
    raw_ws = rng.integers(50, 2500, size=(366 * 24, n)).astype(np.int32)
    raw_wd = rng.integers(0, 36000, size=(366 * 24, n)).astype(np.int32)
    datasets = {'windspeed_100m': raw_ws, 'winddirection_100m': raw_wd}
    scale = {'windspeed_100m': 100.0, 'winddirection_100m': 100.0}
    return coords, datasets, scale


def test_wtk_aws_through_hsds_stub_equals_jax(monkeypatch, tmp_path):
    """The AWS source through an h5pyd-shaped stub: the contiguous read
    of the h5pyd branch and the scale factors, equal to the JAX package's
    and to the raw data."""
    coords, datasets, scale = _hsds_fixture()
    monkeypatch.setitem(sys.modules, 'h5pyd',
                        make_hsds_stub(coords, datasets, scale))
    monkeypatch.chdir(tmp_path)
    tdata.create_hscfg_file('not-a-real-key', str(tmp_path / '.hscfg'))
    bounds = (-106.4, 42.6, -105.9, 43.1)
    layers = ['windspeed_100m', 'winddirection_100m']
    tw = tdata.WTK('AWS', bounds, layers, str(tmp_path / 't'))
    jw = jdata.WTK('AWS', bounds, layers, str(tmp_path / 'j'))
    assert tw.module_name == jw.module_name == 'h5pyd'
    assert tw.years == jw.years == list(range(2007, 2015))
    assert tw.file_names == jw.file_names
    when = datetime(2010, 6, 15, 14)
    tw.download_data(when)
    got = tw.get_dataframe_for_this_time(when)
    want = jw.download_data_for_this_time(when)
    _same(got, want[got.columns], maxulp=1)
    np.testing.assert_array_equal(
        np.stack([got['Latitude'], got['Longitude']], axis=1),
        coords[got['Indices']])
    tidx = (when - datetime(2010, 1, 1)).days * 24 + when.hour
    for name in layers:
        np.testing.assert_array_equal(
            got[name], datasets[name][tidx, got['Indices']] / 100.0)
    with pytest.raises(ValueError, match='outside this'):
        tw.download_data_for_this_time(datetime(2019, 6, 15, 14))


def test_wtk_h5pyd_branch_equals_h5py_branch(wtk_h5, tmp_path, monkeypatch):
    """One contiguous read and a subset (h5pyd) gives what h5py's indexed
    read gives."""
    import types

    class FakeHsdsFile:
        def __init__(self, path, mode='r'):
            assert path.startswith('/nrel/wtk/conus/wtk_conus_'), path
            self._f = h5py.File(wtk_h5, mode)

        def __enter__(self):
            return self._f

        def __exit__(self, *exc):
            self._f.close()
            return False

    fake = types.ModuleType('h5pyd')
    fake.File = FakeHsdsFile
    monkeypatch.setitem(sys.modules, 'h5pyd', fake)
    aws = tdata.WTK('AWS', WTK_BOUNDS, LAYERS, str(tmp_path / 'aws'))
    local = _wtk(tdata, wtk_h5, tmp_path / 'local')
    when = datetime(YEAR, 6, 17, 13)
    a = aws.download_data_for_this_time(when)
    b = local.download_data_for_this_time(when)
    assert a.equals(b)


def test_wtk_aws_missing_credentials_guidance(monkeypatch, tmp_path):
    coords, datasets, scale = _hsds_fixture()
    monkeypatch.setitem(sys.modules, 'h5pyd',
                        make_hsds_stub(coords, datasets, scale))
    monkeypatch.chdir(tmp_path)  # no .hscfg here
    if os.path.exists(os.path.expanduser('~/.hscfg')):
        pytest.skip('a real ~/.hscfg exists on this machine')
    msgs = []
    for mod in (jdata, tdata):
        with pytest.raises(ValueError,
                           match='developer.nrel.gov/signup') as err:
            mod.WtkSource('AWS')
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_wtk_source_module_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, 'h5pyd', None)
    with pytest.raises(ImportError, match='needs the h5pyd module'):
        tdata.WtkSource('AWS')


def test_create_hscfg_equals_jax(tmp_path):
    tdata.create_hscfg_file('MY_API_KEY', str(tmp_path / 't'))
    jdata.create_hscfg_file('MY_API_KEY', str(tmp_path / 'j'))
    text = (tmp_path / 't').read_text()
    assert text == (tmp_path / 'j').read_text()
    lines = dict(line.split(' = ') for line in text.strip().splitlines())
    assert lines['hs_endpoint'] == 'https://developer.nrel.gov/api/hsds'
    assert lines['hs_api_key'] == 'MY_API_KEY'


# ---- what the package imports -----------------------------------------------

def test_port_data_exports_and_imports():
    assert set(jdata.__all__) <= set(tdata.__all__)
    code = ('import sys, ssrs_tpu_torch, ssrs_tpu_torch.data, '
            'ssrs_tpu_torch.simulator; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "ssrs_tpu", "pandas", "requests", "h5py", '
            '"h5pyd", "matplotlib")]; assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True)
