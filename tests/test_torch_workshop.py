"""The reference's regional case studies through the port, on the CPU.

The five workshop cases of ``tests/test_workshop_cases.py`` (reference
workshop/ssrs_demo.ipynb, fixed seeds 30/20) run through
``ssrs_tpu_torch.Simulator`` at that file's scaling (400 m, 800 steps,
300 tracks), with the reference demo's figures. The terrain is the
synthetic DEM (every request refused) and the snapshot case reads a
``LOCAL`` WindToolKit fixture. Per case: every artifact under the
reference naming, the presence mass drifting in the configured direction,
and a rerun with the same bits: from nothing for the first case, from the
first run's potential for the others (a solve is most of a case's time
on the CPU).

One uniform case and the snapshot case also run through ``ssrs_tpu``
with 8,192 tracks, the port on ``ssrs_tpu``'s potential: the same
artifact and figure names, and counts within L1 0.08 of each other.

The uniform configurations of the three example regions
(``examples/*.py``, carried over with ``dataclasses.asdict``) run through
the port's CLI at 400 m.
"""

import dataclasses
import importlib
import json
import os
import pickle
import shutil
import sys
from dataclasses import replace
from datetime import datetime

import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu.data as jax_data
import ssrs_tpu_torch
import ssrs_tpu_torch.data as data_mod
from ssrs_tpu.agents.presence import smooth_presence
from ssrs_tpu_torch import Config, Simulator
from ssrs_tpu_torch.__main__ import main

h5py = pytest.importorskip('h5py')
matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 400.
MAX_STEPS = 800
TRACKS = 300
# the figures at a low resolution: their content, not their pixels, is
# what these tests check
FIG_DPI = 30
# the tracks of a case held against ssrs_tpu: at 300 the two packages'
# maps differ by 0.17-0.22 in L1 from their generators alone
AGAINST_JAX_TRACKS = 8192

wy_test1 = Config(
    run_name='wy_test', sim_seed=30,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(60., 50.),
    resolution=RES, sim_mode='uniform', uniform_windspeed=10.,
    uniform_winddirn=270., track_direction=0, track_count=TRACKS,
    track_start_region=(5., 55., 1., 2.), updraft_threshold=0.75,
    track_max_steps=MAX_STEPS, fig_dpi=FIG_DPI)

wy_test2 = replace(wy_test1, uniform_windspeed=8., uniform_winddirn=90.,
                   track_direction=-45, track_start_region=(55., 60., 0., 5.))

alt_test1 = replace(wy_test1, run_name='alt_test',
                    southwest_lonlat=(-121.8, 37.55),
                    region_width_km=(40., 40.), sim_mode='snapshot',
                    snapshot_datetime=(2012, 3, 29, 10),
                    track_direction=180,
                    track_start_region=(2., 38., 38., 40.))

apl_test1 = replace(wy_test1, run_name='apl_test',
                    southwest_lonlat=(-79.71, 39.03),
                    region_width_km=(60., 60.), sim_mode='uniform',
                    uniform_windspeed=5., uniform_winddirn=315.,
                    track_direction=0, track_start_region=(5., 55., 0., 2.))

apl_test2 = replace(apl_test1, track_direction=180,
                    track_start_region=(5., 55., 58., 60.), sim_seed=20)

# (config, case id, drift check on the presence centroid (row, col))
CASES = {
    'wy_north': (wy_test1, 's10d270',
                 lambda r, c, nrow, ncol: r > 2000. / RES),
    'wy_northwest': (wy_test2, 's8d90',
                     lambda r, c, nrow, ncol: r > 2500. / RES
                     and c < 57500. / RES),
    'alt_south': (alt_test1,
                  datetime(2012, 3, 29, 10).strftime('y%Ym%md%dh%H'),
                  lambda r, c, nrow, ncol: r < nrow - 2000. / RES),
    'apl_north': (apl_test1, 's5d315', lambda r, c, nrow, ncol:
                  r > 2000. / RES),
    'apl_south': (apl_test2, 's5d315', lambda r, c, nrow, ncol:
                  r < nrow - 2000. / RES),
}
EXAMPLES = {'example_altamontpass': 'config_uniform_north',
            'example_appalachian': 'config_uniform_north',
            'example_jem': 'config_jem_uniform_north'}


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


@pytest.fixture(scope='module')
def wtk_2012_h5(tmp_path_factory):
    """LOCAL WTK fixture over the Altamont region for 2012, the archive of
    ``tests/test_workshop_cases.py``: coordinates and per-variable (time,
    site) int datasets with ``scale_factor`` attributes."""
    fpath = str(tmp_path_factory.mktemp('wtk_ws') / 'wtk_ws_2012.h5')
    rng = np.random.default_rng(11)
    lats = np.linspace(37.3, 38.2, 30)
    lons = np.linspace(-122.1, -121.0, 30)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
    nsites = coords.shape[0]
    ntimes = 24 * 366
    layers = {'windspeed_100m': 8., 'winddirection_100m': 200.,
              'pressure_100m': 90000., 'temperature_100m': 12.,
              'boundary_layer_height': 800., 'surface_heat_flux': 120.}
    with h5py.File(fpath, 'w') as f:
        f.create_dataset('coordinates', data=coords)
        for name, base in layers.items():
            vals = base * (1. + 0.15 * rng.standard_normal((ntimes, nsites)))
            ds = f.create_dataset(name, data=(vals * 10.).astype('i4'))
            ds.attrs['scale_factor'] = 10.0
    return fpath


def _run_case(cfg, out_dir, wtk_h5, potential=None):
    """One case the reference demo's way: simulate, then its figures;
    ``potential`` is a ``_potential.npy`` to start from."""
    cfg = replace(cfg, out_dir=str(out_dir))
    if potential is not None:
        data = out_dir / cfg.run_name / 'data' / cfg.sim_mode
        data.mkdir(parents=True)
        shutil.copy(potential, data)
    with pytest.MonkeyPatch.context() as mp:
        if cfg.sim_mode == 'snapshot':
            template = wtk_h5.replace('2012', '$YEAR')

            class LocalWTK(data_mod.WTK):
                def __init__(self, source_name, lonlat_bounds, varnames,
                             out_dir, **kw):
                    super().__init__('LOCAL', lonlat_bounds, varnames,
                                     out_dir, local_template=template,
                                     local_years=[2012])

            mp.setattr(data_mod, 'WTK', LocalWTK)
        sim = Simulator(cfg, device='cpu')
    sim.simulate_tracks()
    for call in ('plot_terrain_features', 'plot_wtk_layers',
                 'plot_directional_potentials', 'plot_simulated_tracks',
                 'plot_presence_map'):
        getattr(sim, call)()
    return sim


def _centroid(counts):
    p = counts.astype(np.float64)
    p /= p.sum()
    rows = p.sum(axis=1) @ np.arange(p.shape[0])
    cols = p.sum(axis=0) @ np.arange(p.shape[1])
    return rows, cols


@pytest.mark.parametrize('name', list(CASES))
def test_workshop_case(name, tmp_path, wtk_2012_h5):
    cfg, case_id, drifts = CASES[name]
    sim = _run_case(cfg, tmp_path / 'a', wtk_2012_h5)
    assert sim.case_ids == [case_id]
    ident = sim._get_id_string(case_id, 0)
    data = sim.mode_data_dir
    want = {f'{case_id}_orograph.npy', f'{ident}_potential.npy',
            f'{ident}_tracks.pkl', f'{ident}_counts.npy',
            'summary_presence.npy'}
    assert want <= set(os.listdir(data))
    with open(os.path.join(data, f'{ident}_tracks.pkl'), 'rb') as fobj:
        tracks = pickle.load(fobj)
    assert len(tracks) == TRACKS
    assert all(t.dtype == np.int16 and t.ndim == 2 and t.shape[1] == 2
               for t in tracks)
    counts = np.load(os.path.join(data, f'{ident}_counts.npy'))
    assert counts.shape == tuple(sim.gridsize)
    assert counts.sum() == sum(len(t) for t in tracks)
    nrow, ncol = sim.gridsize
    assert drifts(*_centroid(counts), nrow, ncol)
    figs = set(os.listdir(sim.mode_fig_dir))
    assert {f'{ident}_potential.png', f'{ident}_tracks.png',
            f'{sim._get_id_string(case_id)}_presence.png'} <= figs
    assert {'elevation.png', 'slope.png', 'aspect.png'} <= \
        set(os.listdir(sim.fig_dir))
    if cfg.sim_mode == 'snapshot':
        assert f'{case_id}_windspeed_100m.png' in figs
    # a second run, from nothing for the first case: the same bits
    potential = os.path.join(data, f'{ident}_potential.npy')
    rerun = _run_case(cfg, tmp_path / 'b', wtk_2012_h5,
                      None if name == 'wy_north' else potential)
    solver = [r['solver'] for r in rerun.timer.records
              if r['phase'] == 'potential']
    assert solver == ['refined' if name == 'wy_north' else 'cache']
    for fname in (f'{ident}_counts.npy', 'summary_presence.npy',
                  f'{ident}_potential.npy'):
        np.testing.assert_array_equal(
            np.load(os.path.join(rerun.mode_data_dir, fname)),
            np.load(os.path.join(data, fname)))


def _run_jax_case(cfg, out_dir, wtk_h5):
    """The same case through ``ssrs_tpu`` with the same figures."""
    cfg = ssrs_tpu.Config(**dataclasses.asdict(replace(
        cfg, out_dir=str(out_dir))))
    with pytest.MonkeyPatch.context() as mp:
        if cfg.sim_mode == 'snapshot':
            template = wtk_h5.replace('2012', '$YEAR')

            class LocalWTK(jax_data.WTK):
                def __init__(self, source_name, lonlat_bounds, varnames,
                             out_dir, **kw):
                    super().__init__('LOCAL', lonlat_bounds, varnames,
                                     out_dir, local_template=template,
                                     local_years=[2012])

            mp.setattr(jax_data, 'WTK', LocalWTK)
        sim = ssrs_tpu.Simulator(cfg)
    sim.simulate_tracks()
    for call in ('plot_terrain_features', 'plot_wtk_layers',
                 'plot_directional_potentials', 'plot_simulated_tracks',
                 'plot_presence_map'):
        getattr(sim, call)()
    return sim


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files}


def _norm_map(counts):
    a = np.asarray(smooth_presence(np.asarray(counts, np.int32), 3),
                   np.float64)
    return a / a.sum()


@pytest.mark.parametrize('name', ['wy_north', 'alt_south'])
def test_workshop_case_against_jax(name, tmp_path, wtk_2012_h5):
    """A uniform case and the snapshot case in both packages, with more
    tracks, the port on ``ssrs_tpu``'s potential: the same artifact and
    figure names, and counts within the L1 bound of
    ``tests/test_torch_simulator.py`` (0.08 of the smoothed, normalized
    maps; the two packages draw their moves from different generators)."""
    cfg, case_id, _ = CASES[name]
    cfg = replace(cfg, track_count=AGAINST_JAX_TRACKS)
    jax_sim = _run_jax_case(cfg, tmp_path / 'jax', wtk_2012_h5)
    ident = jax_sim._get_id_string(case_id, 0)
    port = _run_case(cfg, tmp_path / 'port', wtk_2012_h5,
                     os.path.join(jax_sim.mode_data_dir,
                                  f'{ident}_potential.npy'))
    assert port.case_ids == jax_sim.case_ids == [case_id]
    assert os.listdir(port.mode_data_dir)
    assert set(os.listdir(port.mode_data_dir)) == \
        set(os.listdir(jax_sim.mode_data_dir))
    assert _tree(port.fig_dir) == _tree(jax_sim.fig_dir)
    counts = [np.load(os.path.join(sim.mode_data_dir, f'{ident}_counts.npy'))
              for sim in (port, jax_sim)]
    assert counts[0].shape == counts[1].shape == tuple(port.gridsize)
    assert np.abs(_norm_map(counts[0]) - _norm_map(counts[1])).sum() < 0.08


def _example_config(module, attr):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return getattr(importlib.import_module(f'examples.{module}'), attr)


@pytest.mark.parametrize('module', list(EXAMPLES))
def test_example_region_through_the_cli(module, tmp_path):
    """The example region's uniform variant at 400 m: its JSON through
    ``python -m ssrs_tpu_torch run``, figures included."""
    cfg = dataclasses.asdict(_example_config(module, EXAMPLES[module]))
    cfg.update(resolution=RES, out_dir=str(tmp_path), fig_dpi=FIG_DPI)
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(cfg))
    assert main(['run', str(path), '--device', 'cpu']) == 0
    sim_cfg = ssrs_tpu_torch.Config(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
    run = tmp_path / cfg['run_name']
    ident = f's10d270_d{int(sim_cfg.track_direction)}_t75_fluidflow_r0'
    data = run / 'data' / 'uniform'
    counts = np.load(data / f'{ident}_counts.npy')
    nrow = int(round(cfg['region_width_km'][1] * 1000. / RES))
    ncol = int(round(cfg['region_width_km'][0] * 1000. / RES))
    assert counts.shape == (nrow, ncol)
    with open(data / f'{ident}_tracks.pkl', 'rb') as fobj:
        tracks = pickle.load(fobj)
    assert len(tracks) == cfg['track_count'] == 1000
    assert counts.sum() == sum(len(t) for t in tracks)
    assert np.load(data / 'summary_presence.npy').max() == 1.0
    figs = {str(p.relative_to(run / 'figs'))
            for p in (run / 'figs').rglob('*.png')}
    assert figs == {'elevation.png', 'slope.png', 'aspect.png',
                    f'uniform/{ident}_tracks.png',
                    'uniform/s10d270_d0_t75_fluidflow_presence.png'}
