"""The notebooks' flows through the port, on the CPU.

Each flow runs the code cells of its notebook, read from
``notebooks/<name>.ipynb`` with ``ssrs_tpu`` replaced by
``ssrs_tpu_torch`` and without the lines that pin JAX's platform or call
an IPython magic, so that a change to a notebook shows here. Every HTTP
request is refused (the terrain chain ends at the synthetic DEM), the
working directory is a fresh temporary one (the notebooks write under
``./output``), and the figures go to matplotlib's Agg backend.

- ``terrain_demo``: the root imports, ``Terrain`` falling back to
  ``SYNTHETIC``, ``get_raster_in_projected_crs`` against ``ssrs_tpu``'s on
  the same GeoTIFF (exact), slope and aspect against ``ssrs_tpu``'s
  (rtol 1e-5 + atol 1e-4, float32), and ``TurbinesUSWTB`` from the
  notebook's pandas frame, from the same columns as a dict and through
  ``ssrs_tpu``: equal locations.
- ``wtk_demo``: ``WTK.valid_sources``, ``WtkSource('LOCAL', ...)
  .valid_layers``, ``get_dataframe_for_this_time`` on the notebook's h5py
  archive against ``ssrs_tpu``'s column by column, ``get_coordinates``.
  The port returns a ``Table`` where ``ssrs_tpu`` returns a DataFrame, so
  cell 9's ``wtkdf.loc[:, this_var].values`` reads ``wtkdf[this_var]``.
- ``ssrs_tpu_demo`` (``demo_wy``, ``demo_wy_big``) and ``ssrs_modes``
  (uniform, snapshot, seasonal): every ``Simulator`` of the notebook, on
  ``device='cpu'``; artifact names equal to those of ``ssrs_tpu`` on the
  same configurations; the mass checks on every case's counts (at least
  ``track_count * (burn-in + 1)``, equal to the ``.pkl``'s points where
  tracks were recorded). ``ssrs_tpu`` runs each configuration on the
  port's potentials (a solve is most of a run's time on the CPU), and its
  ``demo_wy`` map is held within L1 0.08 of the port's (the bound of
  ``tests/test_torch_simulator.py``).

Cuts, to fit one test worker's minute (each a ``dataclasses.replace`` of
the notebook's own ``Config`` where the notebook builds a ``Simulator``):

- ``ssrs_tpu_demo``: resolution 400 m (the notebook's 100 m), so
  ``demo_wy`` is 62x75 cells; ``demo_wy_big`` runs 12,000 tracks (the
  notebook's 100,000), still above ``track_pkl_budget`` and so counts
  only, as the notebook's run is.
- ``ssrs_modes``: resolution 500 m (the notebook's 250 m), 100x120 cells.
- ``terrain_demo`` and ``wtk_demo`` run at the notebooks' own size.

The five workshop cases run in ``tests/test_torch_workshop.py``.
"""

import dataclasses
import json
import os
import pickle
import re
import shutil
from datetime import datetime

import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu.data as jax_data
import ssrs_tpu.fields as jax_fields
from ssrs_tpu.agents.presence import smooth_presence

pd = pytest.importorskip('pandas')
h5py = pytest.importorskip('h5py')
matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-4
L1_BOUND = 0.08
CUTS = {
    'ssrs_tpu_demo': {'demo_wy': dict(resolution=400.),
                      'demo_wy_big': dict(resolution=400.,
                                          track_count=12_000)},
    'ssrs_modes': {'modes_wy': dict(resolution=500.)},
}


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """The refined solve's many small ops crawl on a thread pool whose
    cores other test workers hold (``tests/test_torch_potential.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(name):
    """The code cells of a notebook by their index in it, for the port."""
    with open(os.path.join(REPO, 'notebooks', f'{name}.ipynb')) as fobj:
        nb = json.load(fobj)
    cells = {}
    for i, cell in enumerate(nb['cells']):
        if cell['cell_type'] != 'code':
            continue
        lines = [line for line in ''.join(cell['source']).splitlines()
                 if not line.startswith(('%', 'import jax', 'jax.'))]
        cells[i] = re.sub(r'\bssrs_tpu\b', 'ssrs_tpu_torch',
                          '\n'.join(lines))
    return cells


def _run(name, cells, ns, which):
    for i in which:
        exec(compile(cells[i], f'{name}.ipynb, cell {i}', 'exec'), ns)
        plt.close('all')


def test_notebook_cells_are_read():
    """Every notebook this file runs has the cells it names, and each
    refers to the port after the substitution."""
    for name, want in (('terrain_demo', 'from ssrs_tpu_torch import Terrain'),
                       ('wtk_demo', 'from ssrs_tpu_torch import WTK'),
                       ('ssrs_tpu_demo', 'from ssrs_tpu_torch import Config'),
                       ('ssrs_modes', 'from ssrs_tpu_torch import Config')):
        cells = _cells(name)
        assert want in cells[1]
        assert not any('import jax' in c or re.search(r'\bssrs_tpu\b', c)
                       for c in cells.values())


def test_terrain_demo(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cells = _cells('terrain_demo')
    ns = {}
    _run('terrain_demo', cells, ns, sorted(cells))
    assert ns['elevation_layer'] == 'SYNTHETIC'
    assert ns['gridsize'] == (500, 600)
    elevation = ns['elevation']
    assert elevation.shape == (500, 600) and np.isfinite(elevation).all()
    # the reprojection against ssrs_tpu's on the same GeoTIFF
    fpath = ns['region'].get_raster_fpath('SYNTHETIC')
    np.testing.assert_array_equal(elevation, np.asarray(
        jax_data.get_raster_in_projected_crs(
            fpath, ns['bounds'], ns['gridsize'], ns['resolution'],
            ns['proj_crs'])))
    # slope and aspect: torch on the CPU against JAX
    for got, fn in ((ns['slope'], jax_fields.compute_slope_degrees),
                    (ns['aspect'], jax_fields.compute_aspect_degrees)):
        want = np.asarray(fn(elevation, ns['resolution']))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # turbines from the notebook's frame, from its columns as a dict and
    # through ssrs_tpu: the same turbines
    frame = ns['fixture']
    assert isinstance(frame, pd.DataFrame)
    from ssrs_tpu_torch import TurbinesUSWTB
    args = (ns['bounds'], ns['proj_crs'])
    from_dict = TurbinesUSWTB(*args, min_hubheight=60., out_fpath=None,
                              dataframe={k: frame[k].to_numpy()
                                         for k in frame.columns})
    jax_tb = jax_data.TurbinesUSWTB(*args, min_hubheight=60.,
                                    out_fpath=None, dataframe=frame)
    assert ns['turbines'].dframe.equals(from_dict.dframe)
    assert 0 < len(ns['turbines'].dframe) == len(jax_tb.dframe)
    for got, want in zip((ns['turb_xlocs'], ns['turb_ylocs']),
                         jax_tb.get_locations()):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ns['turbines'].dframe.index,
                                  jax_tb.dframe.index)
    assert os.path.isfile(os.path.join(ns['output_dir'], 'turbines.csv'))


def test_wtk_demo(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cells = _cells('wtk_demo')
    assert '.loc[:, this_var].values' in cells[9]
    cells[9] = cells[9].replace('.loc[:, this_var].values', '[this_var]')
    ns = {}
    _run('wtk_demo', cells, ns, sorted(cells))
    assert ns['WTK'].valid_sources == jax_data.WTK.valid_sources
    tpl, years = ns['fixture_tpl'], [2014]
    jax_source = jax_data.WtkSource('LOCAL', local_template=tpl,
                                    local_years=years)
    assert list(ns['wtk_source'].valid_layers) == \
        list(jax_source.valid_layers)
    jax_wtk = jax_data.WTK('LOCAL', ns['lonlat_bounds'], ns['wtk_layers'],
                           str(tmp_path / 'jax'), local_template=tpl,
                           local_years=years)
    want = jax_wtk.get_dataframe_for_this_time(ns['dtime'])
    got = ns['wtkdf']
    # ssrs_tpu's layer columns come in a set's order, the port's in the
    # order asked for
    assert sorted(got.columns) == sorted(want.columns) and len(got) > 100
    assert got.columns[-4:] == ns['wtk_layers']
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    # the sites' coordinates: the port's exactly the archive's; ssrs_tpu
    # reads them back from its wtk_locations.csv through pandas, whose
    # float parser may land one ulp off (ROADMAP.md section 3, hazard 7)
    with h5py.File(tpl.replace('$YEAR', '2014'), 'r') as fobj:
        coords = fobj['coordinates'][:][got['Indices']]
    lonlat = {'Longitude': coords[:, 1], 'Latitude': coords[:, 0]}
    for name in got.columns:
        if name in lonlat:
            np.testing.assert_array_equal(got[name], lonlat[name])
            np.testing.assert_allclose(got[name], want[name].to_numpy(),
                                       rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(got[name], want[name].to_numpy())
    for a, b, exact in zip((ns['xlocs'], ns['ylocs']),
                           jax_wtk.get_coordinates(), lonlat.values()):
        np.testing.assert_array_equal(a, exact)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    head = got.head()
    assert len(head) == 5 and head.columns == got.columns


def _capture_simulators(ns, cuts, made):
    """Make the notebook's ``Simulator`` the port's on the CPU, with the
    cuts of its run name; each one made goes into ``made``."""
    real = ns['Simulator']

    def simulator(config):
        sim = real(dataclasses.replace(config, **cuts[config.run_name]),
                   device='cpu')
        made.append(sim)
        return sim

    ns['Simulator'] = simulator


def _jax_run(config, out_dir, port, presence_map):
    """The configuration through ``ssrs_tpu``, on the potentials of the
    port's run ``port`` (copied into its cache; a name that differs would
    make it solve, and show): its tracks, and its presence map where the
    notebook draws one."""
    config = dataclasses.replace(config, out_dir=str(out_dir))
    data = os.path.join(out_dir, config.run_name, 'data', config.sim_mode)
    os.makedirs(data)
    for name in os.listdir(port.mode_data_dir):
        if name.endswith('_potential.npy'):
            shutil.copy(os.path.join(port.mode_data_dir, name), data)
    sim = ssrs_tpu.Simulator(ssrs_tpu.Config(**dataclasses.asdict(config)))
    sim.simulate_tracks()
    assert {r['solver'] for r in sim.timer.records
            if r['phase'] == 'potential'} <= {'cache', 'cached'}
    if presence_map:
        sim.compute_presence_map()
    return sim


def _check_mass(sim):
    """Every case's counts: at least every track's burn-in, and equal to
    the points of its ``.pkl`` where the tracks were recorded."""
    floor = sim.track_count * (sim.grid.burnin_length() + 1)
    for case in sim.case_ids:
        for real in range(sim.thermals_realization_count or 1):
            ident = sim._get_id_string(case, real)
            counts = np.load(os.path.join(sim.mode_data_dir,
                                          f'{ident}_counts.npy'))
            assert counts.shape == tuple(sim.gridsize) and counts.min() >= 0
            mass = int(counts.sum(dtype=np.int64))
            assert mass >= floor, (ident, mass, floor)
            pkl = os.path.join(sim.mode_data_dir, f'{ident}_tracks.pkl')
            if os.path.exists(pkl):
                with open(pkl, 'rb') as fobj:
                    tracks = pickle.load(fobj)
                assert len(tracks) == sim.track_count
                assert mass == sum(len(t) for t in tracks)


def _norm_map(counts):
    a = np.asarray(smooth_presence(np.asarray(counts, np.int32), 3),
                   np.float64)
    return a / a.sum()


def test_ssrs_tpu_demo(tmp_path, monkeypatch):
    """``demo_wy`` and ``demo_wy_big``; ``demo_wy`` again through
    ``ssrs_tpu`` on the port's potential."""
    monkeypatch.chdir(tmp_path)
    cells = _cells('ssrs_tpu_demo')
    ns, made = {}, []
    _run('ssrs_tpu_demo', cells, ns, [1])
    _capture_simulators(ns, CUTS['ssrs_tpu_demo'], made)
    _run('ssrs_tpu_demo', cells, ns, sorted(cells)[1:])
    sim, big = made
    assert (sim.run_name, big.run_name) == ('demo_wy', 'demo_wy_big')
    assert sim.gridsize == (62, 75)
    for s in made:
        _check_mass(s)
    jax_sim = _jax_run(dataclasses.replace(
        ns['config'], **CUTS['ssrs_tpu_demo']['demo_wy']),
        tmp_path / 'jax', sim, True)
    assert sorted(os.listdir(sim.mode_data_dir)) == \
        sorted(os.listdir(jax_sim.mode_data_dir))
    counts = [s.get_presence_counts(s.case_ids[0], 0)
              for s in (sim, jax_sim)]
    assert np.abs(_norm_map(counts[0]) - _norm_map(counts[1])).sum() \
        < L1_BOUND
    ident = sim._get_id_string(sim.case_ids[0], 0)
    assert {f'{ident}_tracks.png', f'{ident}_potential.png'} <= \
        set(os.listdir(sim.mode_fig_dir))
    # the counts-only run
    jax_big = _jax_run(dataclasses.replace(
        ns['big'], **CUTS['ssrs_tpu_demo']['demo_wy_big']),
        tmp_path / 'jax_big', big, False)
    assert sorted(os.listdir(big.mode_data_dir)) == \
        sorted(os.listdir(jax_big.mode_data_dir))
    assert not any(n.endswith('.pkl') for n in os.listdir(big.mode_data_dir))
    assert int(ns['counts'].sum()) == int(
        big.get_presence_counts(big.case_ids[0], 0).sum(dtype=np.int64))


def test_ssrs_modes(tmp_path, monkeypatch):
    """The uniform, snapshot and seasonal runs of the notebook."""
    monkeypatch.chdir(tmp_path)
    cells = _cells('ssrs_modes')
    ns, made = {}, []
    _run('ssrs_modes', cells, ns, [1])
    _capture_simulators(ns, CUTS['ssrs_modes'], made)
    _run('ssrs_modes', cells, ns, [i for i in sorted(cells) if i > 1])
    assert [s.sim_mode for s in made] == ['uniform', 'snapshot', 'seasonal']
    cuts = CUTS['ssrs_modes']['modes_wy']
    configs = [ns['config_uniform'], ns['config_snapshot'],
               ns['config_seasonal']]
    for i, (sim, config) in enumerate(zip(made, configs)):
        assert sim.gridsize == (100, 120)
        _check_mass(sim)
        jax_sim = _jax_run(dataclasses.replace(config, **cuts),
                           tmp_path / f'jax{i}', sim, True)
        assert sim.case_ids == jax_sim.case_ids
        assert sorted(os.listdir(sim.mode_data_dir)) == \
            sorted(os.listdir(jax_sim.mode_data_dir))
    assert made[1].case_ids == [datetime(2014, 12, 1, 15).strftime(
        'y%Ym%md%dh%H')]
    assert len(made[2].case_ids) == 2
    assert 'summary_presence.npy' in os.listdir(made[2].mode_data_dir)
