"""The port's solve policy and the seasonal deployment's spans.

- A seasonal ``Simulator`` (the Appalachian example's region, season and
  track settings, cut to 6x5 km at 100 m and 3 cases) on the benchmark's
  WTK stand-in (``benchmark/wtk.py``, read through its ``h5py``-shaped
  reader as the ``LOCAL`` source) against the benchmark's float64
  reference (``benchmark/wtkref.py``): the sampled case ids, every
  thresholded updraft, and every potential's interior residual
  (``benchmark/reference.py::interior_residual``).
- The re-solve (``Simulator._finish_potential_solve_pair``): a refined
  solve left above ``RESOLVE_TRIGGER`` by its pass budget is solved again
  from its iterate and kept at or under the trigger; one that neither
  re-solve, from its iterate and from the cold start, can bring there
  (the 64x64 speckle field at 225 degrees) goes to the host direct solve;
  each is counted on the ``potential`` record, each re-solve under a
  ``potential.resolve`` span; in a batched prep the stalled cases' first
  re-solve is one batch. A solve that converges the first time is
  bitwise the plain refined solve, with no re-solve; past the fallback
  cap the 5e-3 net is unchanged.
- The new spans and counters in ``timer.records``: ``wtk_interp.sites``,
  ``wtk_interp.griddata`` with ``griddata_calls``, ``resolves`` and
  ``fallbacks``.
"""

import os
import sys

import numpy as np
import pytest
import requests
import torch

import ssrs_tpu_torch
import ssrs_tpu_torch.simulator as tsim
from ssrs_tpu_torch.potential import (boundary_masks, lap,
                                      solve_potential_direct,
                                      solve_potential_refined)
from ssrs_tpu_torch.potential.fields import conductivity_hard, speckle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import reference as ref  # noqa: E402
from benchmark import terrain, wtk, wtkref  # noqa: E402

# the Appalachian example's seasonal run (NREL/SSRS
# examples/example_appalachian.py), cut to 60x50 cells and 3 cases
SEASONAL = {
    'sim_mode': 'seasonal', 'southwest_lonlat': [-79.7, 39.0],
    'projected_crs': 'ESRI:102008', 'region_width_km': [6.0, 5.0],
    'resolution': 100.0, 'seasonal_start': [3, 1], 'seasonal_end': [6, 1],
    'seasonal_timeofday': 'daytime', 'seasonal_count': 3,
    'wtk_orographic_height': 100, 'wtk_thermal_height': 100,
    'wtk_interp_type': 'linear', 'updraft_threshold': 0.75,
    'track_direction': 0.0, 'track_start_region': [1.0, 5.0, 0.0, 1.0],
    'track_max_steps': 300, 'potential_batch': 2,
    'wtk_standin': {'years': [2012], 'seed': 7, 'spacing_km': 2.0}}
SEED = 2147483901
# the float64 reference's fields against the program's float32 ones: the
# benchmark's updraft_gap limit, which sound runs meet by 5x
UPDRAFT_GAP = 1e-3
# the benchmark's potential_resid limit of every cell
RESID = 5e-4


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """A solve is thousands of small ops, which crawl on a thread pool
    beside the other test workers; one thread also gives the fields the
    same bits in every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def seasonal(tmp_path_factory):
    """(the run's ``Simulator`` after its tracks and map, the DEM and its
    bounds)."""
    root = str(tmp_path_factory.mktemp('seasonal'))
    dem, bounds = terrain.make_dem(SEASONAL)
    data = os.path.join(root, 'run', 'data')
    os.makedirs(data)
    terrain.write_dem_tiff(os.path.join(data, 'srtm1.tif'), dem, bounds)
    lat, lon = wtk.sites(terrain.region(SEASONAL)[2], 2.0, 7)
    template = os.path.join(root, 'standin_$YEAR.wtk')
    wtk.write(template.replace('$YEAR', '2012'), lat, lon,
              wtk.year_hours(2012), wtk.layer_names(SEASONAL))
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in SEASONAL.items() if k != 'wtk_standin'}
    with wtk.reader_installed():
        sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            **fields, sim_seed=SEED, track_count=200, out_dir=root,
            run_name='run', wtk_source='LOCAL', wtk_local_template=template,
            wtk_local_years=(2012,)), device='cpu')
        sim.simulate_tracks()
        sim.compute_presence_map()
    return sim, dem, bounds


def _pot(sim, case):
    return np.load(os.path.join(sim.mode_data_dir,
                                f'{sim._get_id_string(case, 0)}'
                                '_potential.npy'))


def test_seasonal_run_against_the_reference(seasonal):
    sim, dem, bounds = seasonal
    want = wtkref.cases(SEASONAL, SEED)
    assert sorted(sim.case_ids) == sorted(want) and len(want) == 3
    fields = wtkref.Fields(SEASONAL, dem, bounds, 'cpu')
    for case in sim.case_ids:
        got = sim.load_updrafts(case)[0].to(torch.float64)
        gap = float((got - fields.thresholded(want[case])).abs().max())
        assert gap <= UPDRAFT_GAP, (case, gap)
        pot = torch.from_numpy(_pot(sim, case))
        assert ref.interior_residual(pot, got, 0.) <= RESID, case


def test_seasonal_spans_and_counters(seasonal):
    sim = seasonal[0]
    recs = sim.timer.records
    by = {r['span']: r for r in recs}
    interps = [r for r in recs if r['phase'] == 'wtk_interp']
    assert len(interps) == 3
    # two wind components a case, each a linear and a nearest griddata
    assert [r['griddata_calls'] for r in interps] == [4, 4, 4]
    sites = [r for r in recs if r['phase'] == 'wtk_interp.sites']
    grids = [r for r in recs if r['phase'] == 'wtk_interp.griddata']
    assert len(sites) == 6 and len(grids) == 12
    assert {by[r['parent']]['phase'] for r in sites + grids} == \
        {'wtk_interp'}
    assert sorted(r['method'] for r in grids) == ['linear'] * 6 + \
        ['nearest'] * 6
    pots = [r for r in recs if r['phase'] == 'potential']
    assert len(pots) == 3
    for r in pots:
        assert r['resolves'] in (0, 1, 2) and r['fallbacks'] in (0, 1)
        assert r['fallbacks'] == int(r['fallback'])
    resolves = [r for r in recs if r['phase'] == 'potential.resolve']
    assert len(resolves) == sum(r['resolves'] for r in pots)


# ---- the re-solve ----------------------------------------------------------


@pytest.fixture
def port(tmp_path):
    """A CPU ``Simulator`` of a 64x64 grid (12.8 km at 200 m)."""
    return ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), run_name='net', region_width_km=(12.8, 12.8),
        resolution=200., track_count=10, mesh_devices=1), device='cpu')


def _records(sim, name):
    return [r for r in sim.timer.records if r['phase'] == name]


def _finish(sim, handle):
    """``_finish_potential_solve_pair`` of ``handle`` inside a span, as a
    run finishes its solves under its phases."""
    with sim.timer.span('test'):
        return sim._finish_potential_solve_pair(handle)


def test_converged_solve_is_bitwise_the_plain_solve(port):
    cond = conductivity_hard((64, 64), seed=1)
    handle = port._begin_potential_solve(cond)
    host, dev = _finish(port, handle)
    bmask, bvals = boundary_masks(0., (64, 64))
    plain, rrel = solve_potential_refined(torch.from_numpy(cond), bmask,
                                          bvals)
    assert rrel <= tsim.RESOLVE_TRIGGER
    assert torch.equal(dev, plain) and np.array_equal(host, plain.numpy())
    info = handle[-1]
    assert (info['resolves'], info['fallbacks'], info['fallback'],
            info['resolve_rrel']) == (0, 0, False, None)
    assert not _records(port, 'potential.resolve')


def test_solve_above_the_trigger_is_resolved_and_kept(port, monkeypatch):
    """One refinement pass leaves the hard field above the trigger; the
    re-solve, from that iterate with the full budget, ends under it."""
    cond = conductivity_hard((64, 64), seed=1)
    monkeypatch.setattr(lap, '_REFINE_PASSES', 1)
    handle = port._begin_potential_solve(cond)
    monkeypatch.undo()
    first = handle[1][2]
    assert first > tsim.RESOLVE_TRIGGER
    host, dev = _finish(port, handle)
    info = handle[-1]
    assert info['resolves'] == 1 and info['fallbacks'] == 0
    assert info['rrel'] == first
    assert info['resolve_rrel'] <= tsim.RESOLVE_TRIGGER
    assert dev is not None and np.array_equal(host, dev.numpy())
    span, = _records(port, 'potential.resolve')
    assert (span['cases'], span['warm']) == (1, True)
    solve, = [r for r in _records(port, 'potential.solve')
              if r['parent'] == span['span']]
    assert solve['iterations'] > 0
    assert ref.interior_residual(dev, torch.from_numpy(cond), 0.) <= RESID


def test_resolve_that_stays_above_falls_back(port, monkeypatch, capsys):
    """The speckle field at 225 degrees stalls in both re-solves, from its
    iterate and from the cold start: the host direct solve answers, and
    each is counted."""
    monkeypatch.setattr(port, 'track_direction', 225.)
    cond = speckle(np.random.default_rng(225), (64, 64), 0.5)
    handle = port._begin_potential_solve(cond)
    host, dev = _finish(port, handle)
    info = handle[-1]
    assert info['rrel'] > 5e-3
    assert info['resolve_rrel'] > tsim.RESOLVE_TRIGGER
    assert (info['resolves'], info['fallbacks'], info['fallback']) == \
        (2, 1, True)
    assert dev is None
    np.testing.assert_array_equal(host, solve_potential_direct(cond, 225.))
    assert [r['warm'] for r in _records(port, 'potential.resolve')] == \
        [True, False]
    assert 'falling back to the f64 direct solver' in capsys.readouterr().out


def test_past_the_cap_the_net_is_unchanged(port, monkeypatch):
    """Past ``potential_fallback_max_unknowns`` a solve under 5e-3 (two
    refinement passes of the hard field) is kept as it is, with no
    re-solve, and one above it raises."""
    monkeypatch.setattr(port, 'potential_fallback_max_unknowns', 64 * 64 - 1)
    cond = conductivity_hard((64, 64), seed=1)
    monkeypatch.setattr(lap, '_REFINE_PASSES', 2)
    handle = port._begin_potential_solve(cond)
    monkeypatch.setattr(lap, '_REFINE_PASSES', 30)
    assert tsim.RESOLVE_TRIGGER < handle[1][2] <= 5e-3
    host, dev = _finish(port, handle)
    assert torch.equal(dev, handle[1][1]) and handle[-1]['resolves'] == 0
    monkeypatch.setattr(port, 'track_direction', 225.)
    bad = port._begin_potential_solve(
        speckle(np.random.default_rng(225), (64, 64), 0.5))
    with pytest.raises(RuntimeError, match='stalled'):
        _finish(port, bad)
    assert not _records(port, 'potential.resolve')


def _batch_sim(tmp_path, dirn):
    return ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), run_name='batch', region_width_km=(12.8, 12.8),
        resolution=200., track_direction=dirn, potential_batch=2,
        track_count=10, mesh_devices=1), device='cpu')


def test_batched_prep_resolves_stalled_cases_together(tmp_path,
                                                      monkeypatch):
    """One refinement pass leaves both cases of a group above the trigger;
    they are solved again together, from their iterates, under one
    ``potential.resolve`` span, and kept."""
    import ssrs_tpu_torch.potential as pmod
    real = pmod.solve_potential_refined_batch

    def one_pass_first(*args, **kw):
        if kw.get('init') is not None:
            return real(*args, **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lap, '_REFINE_PASSES', 1)
            return real(*args, **kw)

    monkeypatch.setattr(pmod, 'solve_potential_refined_batch',
                        one_pass_first)
    sim = _batch_sim(tmp_path, 0.)
    items = [(conductivity_hard((64, 64), seed=s), f'c{s}', 0)
             for s in (1, 2)]
    pots = [sim._finish_directional_potential_pair(h)
            for h in sim.begin_directional_potentials(items)]
    recs = _records(sim, 'potential')
    assert all(r['rrel'] > tsim.RESOLVE_TRIGGER for r in recs)
    assert [(r['resolves'], r['fallbacks']) for r in recs] == [(1, 0)] * 2
    assert all(r['resolve_rrel'] <= tsim.RESOLVE_TRIGGER for r in recs)
    span, = _records(sim, 'potential.resolve')
    assert (span['cases'], span['warm']) == (2, True)
    for (cond, _, _), (host, dev) in zip(items, pots):
        assert dev is not None and np.array_equal(host, dev.numpy())
        assert ref.interior_residual(dev, torch.from_numpy(cond), 0.) \
            <= RESID


def test_batched_prep_resolves_case_by_case(tmp_path):
    """In a batched prep the stalled case alone is re-solved, from its
    iterate in a batch of its own, then alone from the cold start, and
    falls back; its converged neighbour is bitwise the plain batch's
    answer."""
    sim = _batch_sim(tmp_path, 225.)
    bad = speckle(np.random.default_rng(225), (64, 64), 0.5)
    good = conductivity_hard((64, 64), seed=1)
    bmask, bvals = boundary_masks(225., (64, 64))
    plain, _ = lap.solve_potential_refined_batch([bad, good], bmask, bvals,
                                                 device='cpu')
    pots = [sim._finish_directional_potential_pair(h)
            for h in sim.begin_directional_potentials(
                [(bad, 'bad', 0), (good, 'good', 0)])]
    recs = {r['id'].split('_')[0]: r for r in _records(sim, 'potential')}
    assert (recs['bad']['resolves'], recs['bad']['fallbacks']) == (2, 1)
    assert recs['good']['rrel'] <= tsim.RESOLVE_TRIGGER
    assert (recs['good']['resolves'], recs['good']['fallbacks']) == (0, 0)
    assert torch.equal(pots[1][1], plain[1])
    assert [(r['cases'], r['warm']) for r in
            _records(sim, 'potential.resolve')] == [(1, True), (1, False)]
