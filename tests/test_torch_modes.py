"""Snapshot and seasonal mode of the port against the JAX package.

Both ``Simulator``s run from one WTK-shaped h5py archive through the
``LOCAL`` source, each in its own ``out_dir``, with every HTTP request
refused (both terrain chains then end at the same synthetic DEM) or
replayed (3DEP, for the slope and aspect layers).

- ``case_ids``, the generator's state after the constructor and the
  start cells: exact (both draw from numpy's generator in one order).
- ``_orograph.npy``: ``rtol=1e-5, atol=1e-4``, the tolerance of the
  uniform slice's fields (float32, transcendentals differ by ulps
  between XLA and torch).
- the interpolated winds: 1e-12 (numpy and scipy on the host in both).
- counts: as ``tests/test_torch_simulator.py`` holds them, L1 < 0.08 of
  the smoothed maps when the port runs on the JAX package's cached
  potential; mass and support otherwise.
- turbine scores on a shared ``summary_presence``: the same order and
  values.
"""

import copy
import os
import pickle
import shutil

import numpy as np
import pytest
import requests
import torch

from http_replay import (FakeResponse, FakeWMSServer, ReplayTransport,
                         fixture_bytes)

import ssrs_tpu
import ssrs_tpu.simulator as jsim_mod
import ssrs_tpu_torch
import ssrs_tpu_torch.simulator as tsim_mod
from ssrs_tpu.agents import get_starting_indices as jstarts
from ssrs_tpu.agents.presence import smooth_presence
from ssrs_tpu_torch.agents import fused_chunk
from ssrs_tpu_torch.agents.fused_step import launch_count, \
    reset_launch_count
from ssrs_tpu_torch.data import Table, read_csv
from ssrs_tpu_torch.utils import get_seasonal_datetimes_list

pd = pytest.importorskip('pandas')
h5py = pytest.importorskip('h5py')

YEAR = 2012
LAYERS = ['windspeed_100m', 'winddirection_100m', 'pressure_100m',
          'temperature_100m', 'boundary_layer_height',
          'surface_heat_flux']
RTOL, ATOL = 1e-5, 1e-4
SNAP_CASE = 'y2012m06d17h13'
SNAP_ID = f'{SNAP_CASE}_d0_t75_fluidflow_r0'


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(scope='module')
def wtk_template(tmp_path_factory):
    """A WTK-shaped archive for 2012 up to the end of June: a jittered
    0.02-degree lattice around the tests' WY regions; winds of 4-14 m/s whose
    direction turns over the lattice and from hour to hour."""
    fpath = str(tmp_path_factory.mktemp('wtk') / f'wtk_{YEAR}.h5')
    lats = np.linspace(42.70, 43.00, 16)
    lons = np.linspace(-106.30, -106.00, 16)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    rng = np.random.default_rng(3)
    # off the exact lattice, as WTK's projected grid is in lon/lat: four
    # sites on one circle have two triangulations, and an ulp decides
    lat_g = lat_g + rng.uniform(-2e-3, 2e-3, lat_g.shape)
    lon_g = lon_g + rng.uniform(-2e-3, 2e-3, lon_g.shape)
    coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
    hours = np.arange(24 * 182)[:, None]
    site = np.arange(coords.shape[0])[None, :]
    fields = {
        'windspeed_100m': 9. + 5. * np.sin(0.37 * hours + 0.05 * site),
        'winddirection_100m': np.mod(
            200. + 7. * hours + 300. * (lon_g.ravel()[None, :] + 106.15)
            + 200. * (lat_g.ravel()[None, :] - 42.85), 360.),
    }
    with h5py.File(fpath, 'w') as f:
        f.create_dataset('coordinates', data=coords)
        for name in LAYERS:
            vals = fields.get(name)
            if vals is None:
                vals = rng.uniform(1, 300, (hours.size, site.size))
            ds = f.create_dataset(name, data=(vals * 100.).astype('i4'))
            ds.attrs['scale_factor'] = 100.0
    return fpath.replace(str(YEAR), '$YEAR')


def _config(wtk_template, **kw):
    base = dict(
        sim_seed=4, southwest_lonlat=(-106.21, 42.78),
        region_width_km=(12., 10.), resolution=200.,
        track_direction=0., track_start_region=(1., 11., 1., 2.),
        track_start_type='random', track_max_steps=400,
        movement_model='fluidflow', potential_solver='direct',
        mesh_devices=1, wtk_source='LOCAL', wtk_local_template=wtk_template,
        wtk_local_years=(YEAR,), max_cores=2)
    return {**base, **kw}


def _load(sim, name):
    return np.load(os.path.join(sim.mode_data_dir, name))


def _norm_map(counts):
    a = np.asarray(smooth_presence(np.asarray(counts, np.int32), 3),
                   np.float64)
    return a / a.sum()


def _next_starts(sim):
    """The start cells the simulator would draw next, from a copy of its
    generator (through each package's own function)."""
    fn = jstarts if isinstance(sim, ssrs_tpu.Simulator) else \
        ssrs_tpu_torch.agents.get_starting_indices
    rows, cols = fn(int(sim.track_count), list(sim.track_start_region),
                    sim.track_start_type, tuple(sim.region_width_km),
                    float(sim.resolution), rng=copy.deepcopy(sim._rng))
    return np.stack([rows, cols], axis=1)


TURBINES = dict(
    t_state=['WY'] * 6, p_name=['P1', 'P1', 'P2', 'P2', 'P3', 'P3'],
    p_year=[2015] * 6, t_cap=[2000] * 6,
    # the fourth is below the hub height, the last two outside the region
    t_hh=[90., 80., 95., 40., 90., 90.], t_rd=[100., 90., 110., 40., 100.,
                                               100.],
    xlong=[-106.18, -106.15, -106.12, -106.16, -105.5, -106.15],
    ylat=[42.80, 42.81, 42.83, 42.82, 42.80, 44.0])


def _fixture_turbines(monkeypatch):
    """Both simulators get TURBINES instead of the USWTDB answer, and keep
    their ``turbines.csv``."""
    class JaxTB(ssrs_tpu.data.TurbinesUSWTB):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dataframe=pd.DataFrame(TURBINES),
                             **kwargs)

    class PortTB(ssrs_tpu_torch.data.TurbinesUSWTB):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dataframe=dict(TURBINES), **kwargs)

    monkeypatch.setattr(jsim_mod, 'TurbinesUSWTB', JaxTB)
    monkeypatch.setattr(tsim_mod, 'TurbinesUSWTB', PortTB)


# ---- snapshot mode ----------------------------------------------------------

@pytest.fixture(scope='module')
def snap(tmp_path_factory, wtk_template):
    """(JAX simulator, port on the JAX package's potential, port on its
    own), the snapshot of 2012-06-17 13:00 with 4096 tracks, counts only,
    with the fixture turbines."""
    root = tmp_path_factory.mktemp('snap')
    kw = _config(wtk_template, run_name='snap', sim_mode='snapshot',
                 snapshot_datetime=(YEAR, 6, 17, 13), track_count=4096,
                 track_pkl_budget=0, track_tail_bucket=4096)
    with pytest.MonkeyPatch.context() as mp:
        _fixture_turbines(mp)
        jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
            out_dir=str(root / 'jax'), **kw))
        state = dict(jax=copy.deepcopy(jax_sim._rng.bit_generator.state),
                     jax_starts=_next_starts(jax_sim))
        jax_sim.simulate_tracks()
        jax_sim.compute_presence_map()
        ports = []
        for name in ('shared', 'own'):
            port = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
                out_dir=str(root / name), **kw), device='cpu')
            state[name] = copy.deepcopy(port._rng.bit_generator.state)
            state[name + '_starts'] = _next_starts(port)
            if name == 'shared':
                shutil.copy(os.path.join(jax_sim.mode_data_dir,
                                         f'{SNAP_ID}_potential.npy'),
                            port.mode_data_dir)
            port.simulate_tracks()
            port.compute_presence_map()
            ports.append(port)
    return jax_sim, ports[0], ports[1], state


def test_snapshot_case_ids_rng_and_starts(snap):
    jax_sim, shared, own, state = snap
    assert jax_sim.case_ids == shared.case_ids == own.case_ids == [SNAP_CASE]
    assert shared.dtimes == jax_sim.dtimes
    assert state['shared'] == state['own'] == state['jax']
    np.testing.assert_array_equal(state['own_starts'], state['jax_starts'])
    assert shared.wtk_layers == jax_sim.wtk_layers
    assert shared.terrain_layers == jax_sim.terrain_layers == \
        {'Elevation': 'SYNTHETIC'}


def test_snapshot_artifact_names(snap):
    jax_sim, shared, own, _ = snap
    want = set(os.listdir(jax_sim.mode_data_dir))
    assert set(os.listdir(own.mode_data_dir)) == want
    assert set(os.listdir(shared.mode_data_dir)) == want
    assert {'turbines.csv', 'wtk_locations.csv', 'wtk_locations_bounds.json',
            f'{SNAP_CASE}_wtk.csv', f'{SNAP_CASE}_orograph.npy',
            f'{SNAP_ID}_potential.npy', f'{SNAP_ID}_counts.npy',
            'summary_presence.npy'} == want
    for sim in (jax_sim, own):
        assert os.path.isfile(os.path.join(sim.out_dir, 'snap',
                                           'phase_timings.json'))


def test_snapshot_wtk_frame_and_interpolated_winds(snap, monkeypatch):
    """The same frame at the same sites through each package's
    interpolation: within 1e-12. (On its own cache the JAX package reads
    some coordinates one ulp off, through pandas' default float parser;
    that alone moves a wind direction by 7e-12 degrees.)"""
    jax_sim, _, own, _ = snap
    when = jax_sim.dtimes[0]
    frame = own.wtk.get_dataframe_for_this_time(when)
    jframe = jax_sim.wtk.get_dataframe_for_this_time(when)
    for name in LAYERS:
        np.testing.assert_array_equal(frame[name], jframe[name].to_numpy())
    speed = frame['windspeed_100m']
    assert 4. <= speed.min() and speed.max() <= 14. and len(speed) > 30
    for got, want in zip(own.get_wtk_locs(), jax_sim.get_wtk_locs()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    locs = own.get_wtk_locs()
    monkeypatch.setattr(jax_sim, 'get_wtk_locs', lambda: locs)
    got = own._get_interpolated_wind_conditions(
        frame['windspeed_100m'], frame['winddirection_100m'])
    want = jax_sim._get_interpolated_wind_conditions(
        jframe['windspeed_100m'], jframe['winddirection_100m'])
    for g, w in zip(got, want):
        assert g.shape == own.gridsize and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    # the direction turns over the region
    assert np.ptp(got[1]) > 5.


@pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic'])
def test_interpolation_methods_equal_jax(snap, monkeypatch, method):
    jax_sim, _, own, _ = snap
    rng = np.random.default_rng(9)
    n = len(own.wtk.get_locations())
    speed, dirn = rng.uniform(2, 15, n), rng.uniform(0, 360, n)
    for sim in (jax_sim, own):
        monkeypatch.setattr(sim, 'wtk_interp_type', method)
    locs = own.get_wtk_locs()
    monkeypatch.setattr(jax_sim, 'get_wtk_locs', lambda: locs)
    got = own._get_interpolated_wind_conditions(speed, dirn)
    want = jax_sim._get_interpolated_wind_conditions(speed, dirn)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_interpolation_of_a_cloud_without_a_triangulation(snap,
                                                          monkeypatch):
    """Two WTK points (or points on one line) cannot be triangulated:
    ``linear`` raises inside scipy and the nearest neighbour answers; a
    cell outside the points' hull gets the nearest neighbour too."""
    jax_sim, _, own, _ = snap
    xg, yg = own.get_terrain_grid()
    line = (np.array([xg[5], xg[30], xg[50]]),
            np.array([yg[10], yg[10], yg[10]]))
    for sim in (jax_sim, own):
        monkeypatch.setattr(sim, 'get_wtk_locs', lambda line=line: line)
    vals = np.array([3., 6., 9.])
    got = own._interpolate_wtk_vardata(vals)
    np.testing.assert_array_equal(got,
                                  jax_sim._interpolate_wtk_vardata(vals))
    assert set(np.unique(got)) == {3., 6., 9.}
    tri = (np.array([xg[5], xg[50], xg[25]]),
           np.array([yg[5], yg[5], yg[40]]))
    for sim in (jax_sim, own):
        monkeypatch.setattr(sim, 'get_wtk_locs', lambda tri=tri: tri)
    got = own._interpolate_wtk_vardata(vals)
    np.testing.assert_allclose(got, jax_sim._interpolate_wtk_vardata(vals),
                               rtol=0, atol=1e-12)
    assert np.isfinite(got).all() and got[0, 0] == 3.
    assert 3. < got[10, 25] < 9.


def test_snapshot_orograph(snap):
    jax_sim, shared, own, _ = snap
    want = _load(jax_sim, f'{SNAP_CASE}_orograph.npy')
    got = _load(own, f'{SNAP_CASE}_orograph.npy')
    assert got.dtype == want.dtype == np.float32
    assert got.shape == own.gridsize == (50, 60)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got, _load(shared, f'{SNAP_CASE}_orograph.npy'))
    assert got.max() > 0.75     # some cells above the updraft threshold
    np.testing.assert_allclose(_load(own, f'{SNAP_ID}_potential.npy'),
                               _load(jax_sim, f'{SNAP_ID}_potential.npy'),
                               rtol=0., atol=1e-3)


def test_snapshot_counts(snap):
    jax_sim, shared, own, _ = snap
    cj = _load(jax_sim, f'{SNAP_ID}_counts.npy')
    cs = _load(shared, f'{SNAP_ID}_counts.npy')
    co = _load(own, f'{SNAP_ID}_counts.npy')
    rec = {r['phase']: r for r in shared.timer.records}
    assert rec['potential']['solver'] == 'cache'
    for c in (cs, co):
        assert c.dtype == np.int32 and c.shape == cj.shape and c.min() >= 0
        assert c.sum() >= 4096 * (own.grid.burnin_length() + 1)
    # on the same potential: the statistical bound
    assert np.abs(_norm_map(cs) - _norm_map(cj)).sum() < 0.08
    # on its own potential: the same mass and support
    assert abs(float(co.sum()) / cj.sum() - 1.) < 0.05
    assert ((co > 0) == (cj > 0)).mean() > 0.9
    for sim in (shared, own):
        summary = _load(sim, 'summary_presence.npy')
        assert summary.dtype == np.float32 and summary.max() == 1.0


def test_snapshot_phase_records(snap):
    own = snap[2]
    phases = [r['phase'] for r in own.timer.records]
    for name in ('terrain', 'turbines', 'wtk_download', 'wtk_frame',
                 'wtk_interp', 'updrafts', 'thermals', 'potential',
                 'tracks', 'simulate_tracks', 'presence_map'):
        assert name in phases, name
    assert phases.index('turbines') < phases.index('wtk_download') < \
        phases.index('updrafts')


def test_turbines_csv_and_filter(snap):
    """``turbines.csv`` holds the turbines inside the bounds and at or
    above the hub height, the same rows in both packages, and reads back
    in either."""
    jax_sim, _, own, _ = snap
    want = jax_sim.turbines.dframe
    got = own.turbines.dframe
    assert list(got.index) == list(want.index) == [0, 1, 2]
    assert got.columns == list(want.columns)
    for name in ('t_hh', 't_rd', 'xlong', 'ylat'):
        np.testing.assert_array_equal(got[name], want[name].to_numpy())
    for name in ('x', 'y'):
        np.testing.assert_allclose(got[name], want[name].to_numpy(),
                                   rtol=0, atol=1e-6)
    jcsv = os.path.join(jax_sim.mode_data_dir, 'turbines.csv')
    tcsv = os.path.join(own.mode_data_dir, 'turbines.csv')
    assert read_csv(tcsv).equals(got)
    back = read_csv(jcsv)
    assert list(back.index) == [0, 1, 2] and back.columns == got.columns
    np.testing.assert_allclose(back['x'], got['x'], rtol=0, atol=1e-6)
    assert len(pd.read_csv(tcsv, index_col=0)) == 3


def test_turbine_presence_equals_jax_on_shared_summary(snap, monkeypatch):
    jax_sim, _, own, _ = snap
    summary = _load(jax_sim, 'summary_presence.npy').astype(np.float64)
    for sim in (jax_sim, own):
        monkeypatch.setattr(sim, 'compute_presence_map',
                            lambda radius=1000., s=summary: s)
    want = jax_sim.get_turbine_presence(radius=600.)
    got = own.get_turbine_presence(radius=600.)
    assert isinstance(got, Table)
    assert list(got.index) == list(want.index)
    assert got.columns == list(want.columns)
    np.testing.assert_array_equal(got['presence'],
                                  want['presence'].to_numpy())
    assert list(got['p_name']) == list(want['p_name'])


def test_turbine_presence_scores(snap):
    """One score a turbine, in [0, 1], sorted, each the summary map at the
    cell ``searchsorted`` gives; the turbines' own table is untouched."""
    own = snap[2]
    scores = own.get_turbine_presence(radius=600.)
    summary = _load(own, 'summary_presence.npy')
    pres = scores['presence']
    assert len(scores) == 3 and 'presence' not in own.turbines.dframe
    assert (pres >= 0).all() and (pres <= 1).all()
    assert (np.diff(pres) <= 0).all()
    xgrid, ygrid = own.get_terrain_grid()
    cols = np.clip(np.searchsorted(xgrid, scores['x']), 0, 59)
    rows = np.clip(np.searchsorted(ygrid, scores['y']), 0, 49)
    np.testing.assert_allclose(pres, summary[rows, cols], rtol=1e-6)


def test_turbine_presence_without_turbines(tmp_path, wtk_template):
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), **_config(
            wtk_template, run_name='none', sim_mode='uniform',
            track_count=50, region_width_km=(8., 6.),
            track_start_region=(1., 7., 1., 2.))), device='cpu')
    assert sim.turbines.dframe is None
    assert not os.path.exists(os.path.join(sim.mode_data_dir,
                                           'turbines.csv'))
    with pytest.raises(RuntimeError, match='No turbine data'):
        sim.get_turbine_presence()


def test_snapshot_recorded_run_with_thermals(tmp_path, wtk_template,
                                             monkeypatch):
    """The default ``track_pkl_budget`` records ``_tracks.pkl``: the
    counts equal the recount of the pickle, for the orographic and the
    thermal realization, and the plain versions run on the CPU."""
    _fixture_turbines(monkeypatch)
    reset_launch_count()
    fused_chunk.reset_launch_count()
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), **_config(
            wtk_template, run_name='rec', sim_mode='snapshot',
            snapshot_datetime=(YEAR, 6, 17, 13), track_count=150,
            thermals_realization_count=1)), device='cpu')
    sim.simulate_tracks()
    for real in (0, 1):
        ident = sim._get_id_string(SNAP_CASE, real)
        counts = _load(sim, f'{ident}_counts.npy')
        with open(os.path.join(sim.mode_data_dir,
                               f'{ident}_tracks.pkl'), 'rb') as fobj:
            tracks = pickle.load(fobj)
        assert len(tracks) == 150 and tracks[0].dtype == np.int16
        flat = np.concatenate(tracks).astype(np.int64)
        recount = np.zeros(sim.gridsize, np.int64)
        np.add.at(recount, (flat[:, 0], flat[:, 1]), 1)
        np.testing.assert_array_equal(counts, recount)
        os.remove(os.path.join(sim.mode_data_dir, f'{ident}_counts.npy'))
        np.testing.assert_array_equal(sim.get_presence_counts(SNAP_CASE,
                                                              real), recount)
    assert os.path.isfile(os.path.join(sim.mode_data_dir,
                                       f'{SNAP_CASE}_r0_thermals.npy'))
    scores = sim.get_turbine_presence()
    assert len(scores) == 3 and scores['presence'].max() <= 1.
    assert (launch_count(), fused_chunk.launch_count()) == (0, 0)


def test_snapshot_default_device_needs_a_card(tmp_path, wtk_template):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=str(tmp_path), **_config(
                wtk_template, sim_mode='snapshot',
                snapshot_datetime=(YEAR, 6, 17, 13))))


def test_snapshot_year_outside_the_source(tmp_path, wtk_template):
    with pytest.raises(ValueError, match='outside this'):
        ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=str(tmp_path), **_config(
                wtk_template, sim_mode='snapshot',
                snapshot_datetime=(2010, 6, 17, 13))), device='cpu')


# ---- seasonal mode ----------------------------------------------------------

SEASONAL = dict(
    run_name='seas', sim_mode='seasonal', sim_seed=8, seasonal_count=3,
    seasonal_start=(4, 1), seasonal_end=(5, 30),
    seasonal_timeofday='daytime', region_width_km=(8., 6.), track_count=80,
    track_start_region=(1., 7., 1., 2.), track_max_steps=120,
    movement_model='drw', thermals_realization_count=2, track_pkl_budget=0)


@pytest.fixture(scope='module')
def seas(tmp_path_factory, wtk_template):
    """(JAX simulator, port), a 3-case seasonal run with 2 thermal
    realizations: 9 populations through each package's multi-case
    driver."""
    root = tmp_path_factory.mktemp('seas')
    kw = _config(wtk_template, **SEASONAL)
    jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(out_dir=str(root / 'jax'),
                                                 **kw))
    port = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(root / 'port'), **kw), device='cpu')
    state = dict(jax=copy.deepcopy(jax_sim._rng.bit_generator.state),
                 port=copy.deepcopy(port._rng.bit_generator.state),
                 jax_starts=_next_starts(jax_sim),
                 port_starts=_next_starts(port))
    jax_sim.simulate_tracks()
    port.simulate_tracks()
    return jax_sim, port, state, kw


def test_seasonal_case_ids_rng_and_starts(seas):
    jax_sim, port, state, kw = seas
    assert port.case_ids == jax_sim.case_ids and len(port.case_ids) == 3
    assert port.dtimes == jax_sim.dtimes
    # the cases are those of the sampler on a fresh generator of the seed,
    assert port.dtimes == get_seasonal_datetimes_list(
        [YEAR], (4, 1), (5, 30), 'daytime', 3,
        tuple(port.lonlat_bounds[0:2]), np.random.default_rng(8))
    # and the starts come from the generator after them, as in ssrs_tpu
    assert state['port'] == state['jax']
    np.testing.assert_array_equal(state['port_starts'], state['jax_starts'])
    fresh = np.random.default_rng(8)
    assert state['port'] != copy.deepcopy(fresh.bit_generator.state)


def test_seasonal_artifacts(seas):
    jax_sim, port, _, _ = seas
    names = set(os.listdir(port.mode_data_dir))
    assert names == set(os.listdir(jax_sim.mode_data_dir))
    for case in port.case_ids:
        want = {f'{case}_wtk.csv', f'{case}_orograph.npy',
                f'{case}_r0_thermals.npy', f'{case}_r1_thermals.npy'} | \
            {f'{case}_d0_t75_drw_r{r}_counts.npy' for r in range(3)}
        assert want <= names
        np.testing.assert_allclose(_load(port, f'{case}_orograph.npy'),
                                   _load(jax_sim, f'{case}_orograph.npy'),
                                   rtol=RTOL, atol=ATOL)
        assert len(port.load_updrafts(case)) == 3
    oros = [_load(port, f'{c}_orograph.npy') for c in port.case_ids]
    assert not np.array_equal(oros[0], oros[1])


def test_seasonal_counts_and_presence_map(seas):
    jax_sim, port, _, _ = seas
    recs = [r for r in port.timer.records if r['phase'] == 'batched_tracks']
    assert len(recs) == 1 and recs[0]['cases'] == 9
    floor = 80 * (port.grid.burnin_length() + 1)
    for case in port.case_ids:
        for real in range(3):
            got = _load(port, f'{case}_d0_t75_drw_r{real}_counts.npy')
            want = _load(jax_sim, f'{case}_d0_t75_drw_r{real}_counts.npy')
            assert got.dtype == np.int32 and got.shape == want.shape
            assert got.sum() >= floor and want.sum() >= floor
            assert abs(float(got.sum()) / want.sum() - 1.) < 0.25
    summary = port.compute_presence_map(radius=600.)
    assert np.isclose(summary.max(), 1.0)
    saved = _load(port, 'summary_presence.npy')
    assert saved.dtype == np.float32 and saved.max() == 1.0
    assert saved.shape == _load(
        jax_sim, f'{port.case_ids[0]}_orograph.npy').shape


def test_seasonal_rerun_reads_the_caches(seas, monkeypatch):
    """A second simulator on the same directory opens the source once (the
    layer probe) and reads no dataset: the locations and the frames come
    from the CSV caches, untouched."""
    _, port, _, kw = seas
    opened = []
    real_file = h5py.File

    class Counting(real_file):
        def __init__(self, *args, **kwargs):
            opened.append(args)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(h5py, 'File', Counting)
    csvs = [os.path.join(port.mode_data_dir, n)
            for n in sorted(os.listdir(port.mode_data_dir))
            if n.endswith('.csv')]
    assert len(csvs) == 4
    mtimes = [os.stat(f).st_mtime_ns for f in csvs]
    oros = {c: _load(port, f'{c}_orograph.npy') for c in port.case_ids}
    again = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=port.out_dir, **kw), device='cpu')
    assert len(opened) == 1
    assert [os.stat(f).st_mtime_ns for f in csvs] == mtimes
    assert again.case_ids == port.case_ids
    for c in again.case_ids:
        np.testing.assert_array_equal(_load(again, f'{c}_orograph.npy'),
                                      oros[c])


@pytest.mark.parametrize('model', ['fluidflow', 'drw'])
def test_seasonal_fields_device_on_and_off_bitwise_equal(tmp_path,
                                                         wtk_template, model):
    arts = {}
    for fields_device in (True, False):
        kw = _config(wtk_template, **{
            **SEASONAL, 'run_name': f'fd_{fields_device}',
            'seasonal_count': 2, 'thermals_realization_count': 1,
            'movement_model': model, 'fields_device': fields_device})
        sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=str(tmp_path), **kw), device='cpu')
        sim.simulate_tracks()
        arts[fields_device] = {
            n: _load(sim, n) for n in sorted(os.listdir(sim.mode_data_dir))
            if n.endswith('.npy')}
    assert arts[True].keys() == arts[False].keys()
    assert len(arts[True]) == (2 * 2 + 2 * 2) + (4 if model == 'fluidflow'
                                                 else 0)
    for name in arts[True]:
        np.testing.assert_array_equal(arts[True][name], arts[False][name],
                                      err_msg=name)


# ---- slope and aspect from the terrain source -------------------------------

CAPS = FakeResponse(200, fixture_bytes('threedep_getcapabilities.xml'),
                    'text/xml')


def test_slope_and_aspect_come_from_the_3dep_layers(tmp_path, monkeypatch):
    """With 3DEP the slope and aspect are the service's rasters, not the
    Horn stencil on the DEM: the replayed server gives every layer the
    same analytic field, so slope == aspect == elevation here, in both
    packages, and the orograph follows them."""
    import ssrs_tpu.data.threedep as jthreedep
    import ssrs_tpu_torch.data.threedep as tthreedep
    for mod in (jthreedep, tthreedep):
        real = mod.ThreeDEP.__init__

        def init(self, layer, bnds, fpath, res=1. / 1200., real=real):
            real(self, layer, bnds, fpath, res=res)   # 3 arcsec tiles
        monkeypatch.setattr(mod.ThreeDEP, '__init__', init)
    kw = dict(run_name='dep', sim_mode='uniform', sim_seed=3,
              southwest_lonlat=(-106.21, 42.78), region_width_km=(8., 6.),
              resolution=200., track_count=50,
              track_start_region=(1., 7., 1., 2.), track_max_steps=100,
              potential_solver='direct', mesh_devices=1)
    sims = []
    for name, pkg, extra in (('jax', ssrs_tpu, {}),
                             ('port', ssrs_tpu_torch, dict(device='cpu'))):
        transport = ReplayTransport().install(monkeypatch)
        transport.add('GetCapabilities', CAPS)
        transport.add('GetMap', FakeWMSServer(tmp_path))
        transport.add(lambda url, params: 'uswtdb' in url,
                      FakeResponse(500))
        sims.append(pkg.Simulator(pkg.Config(out_dir=str(tmp_path / name),
                                             **kw), **extra))
        layers = [p['layers'] for _, p in transport.requests
                  if p.get('request') == 'GetMap']
        assert layers == ['3DEPElevation:None',
                          '3DEPElevation:Slope Degrees',
                          '3DEPElevation:Aspect Degrees']
    jax_sim, port = sims
    assert port.terrain_layers == jax_sim.terrain_layers == {
        'Elevation': 'DEM', 'Slope': 'Slope Degrees',
        'Aspect': 'Aspect Degrees'}
    elev = port.get_terrain_elevation()
    np.testing.assert_array_equal(elev, jax_sim.get_terrain_elevation())
    np.testing.assert_array_equal(port.get_terrain_layer('Slope'), elev)
    for got, want in ((port.get_terrain_slope(), jax_sim.get_terrain_slope()),
                      (port.get_terrain_aspect(),
                       jax_sim.get_terrain_aspect())):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, elev.astype(np.float32))
        np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_allclose(_load(port, 's10d270_orograph.npy'),
                               _load(jax_sim, 's10d270_orograph.npy'),
                               rtol=RTOL, atol=ATOL)
    # a source without the layers falls back to the stencil, each alone
    port.terrain_layers = {'Elevation': 'DEM', 'Aspect': 'Aspect Degrees'}
    horn = ssrs_tpu_torch.fields.compute_slope_aspect_degrees(
        torch.from_numpy(elev.astype(np.float32)), port.resolution)
    np.testing.assert_array_equal(port.get_terrain_slope(), horn[0].numpy())
    np.testing.assert_array_equal(port.get_terrain_aspect(),
                                  elev.astype(np.float32))


def test_terrain_chain_falls_to_srtm_then_synthetic(tmp_path, monkeypatch):
    """3DEP refused: the chain takes SRTM1 when its tiles answer, and the
    synthetic DEM when nothing does, as in ssrs_tpu."""
    import ssrs_tpu_torch.data.srtm as tsrtm
    kw = dict(run_name='chain', sim_mode='uniform', sim_seed=3,
              southwest_lonlat=(-106.21, 42.78), region_width_km=(8., 6.),
              resolution=200., track_count=50, mesh_devices=1)

    def fake_tile(self, lat, lon):
        yy, xx = np.mgrid[0:121, 0:121]
        return (1500. + 3. * yy + 2. * xx).astype(np.float32)

    monkeypatch.setattr(tsrtm.SRTM, '_tile', fake_tile)
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path / 'srtm'), **kw), device='cpu')
    assert sim.terrain_layers == {'Elevation': 'SRTM1'}
    elev = sim.get_terrain_elevation()
    assert elev.shape == (30, 40) and elev.min() > 1500.
    assert sim.get_terrain_slope().max() > 0.
    monkeypatch.undo()     # the tiles are refused again
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path / 'syn'), **kw), device='cpu')
    assert sim.terrain_layers == {'Elevation': 'SYNTHETIC'}
