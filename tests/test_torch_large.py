"""BASELINE config 5's path, the large-region run (200x200 km at 30 m,
6667x6667 cells, 100k tracks, presence map and turbine scores), of the
port against the JAX package on the CPU, at cut sizes.

- The slice at config 5's shape, cut in resolution: 200x200 km at 957 m,
  a 209x209 grid whose halvings are odd at 209, 105, 53, 27 and 7, the
  config's wind, start band and step cap, ``potential_solver='auto'``
  and ``track_pkl_budget=0``, so that both packages take the counts-only
  driver (``_run_large``). 8,192 tracks: with 2,000 the two packages'
  smoothed maps on one potential differ by L1 0.12, sampling noise above
  the bound (measured on this grid); with 8,192 by 0.058-0.064. The port
  runs with ``_LARGE_GRID_CELLS`` lowered below this grid, so its run
  takes the branches of the grids past 4096^2 (fields through numpy,
  one unfinished solve at a time).

  - fields: the DEM equal; slope, aspect and orograph at ``rtol=1e-5,
    atol=1e-4`` (transcendentals differ by ulps between XLA and torch);
  - the refined potential of each package through the solver invariants
    of ``tests/test_torch_potential.py``: the range within 1e-3 of
    0..1000 and an exact boundary; the port's also rrel < 1e-5, a
    bitwise-equal re-solve, and its float64 interior residual at most
    1.1x the JAX package's (on this field both stop along the near-null
    mode, past the 2e-4 that the WY field meets);
  - counts: the port on the JAX package's cached potential within the
    L1 bound 0.08 of the JAX package's counts (the pattern of
    ``tests/test_torch_simulator.py``).
- Turbine scores: the JAX package's ``_counts.npy`` copied into the port's
  run, both ``get_turbine_presence()`` give the same turbines in the same
  order, ``presence`` within 1e-6 (the two smoothings are float32
  convolutions that add in another order).
- The branches that act only past 4096^2, on stubs that carry a grid
  size and the methods under test, in both packages: the device-fields
  guard, the finish window of the potential prep, and a stalled solve
  above ``potential_fallback_max_unknowns``, which raises
  ``RuntimeError`` with the same grid, rrel and cost estimate; also on a
  real stalled solve, the 64x64 speckle field at 225 degrees that
  ``tests/test_potential.py`` pins as flagged, with the cap lowered below
  its grid.
- A finished solve leaves no tensor in a reference cycle: with Python's
  cyclic collector off, the large tensors alive after a refined or a
  multigrid solve are the inputs and the potential alone (a V-cycle that
  was a closure calling itself kept a solve's levels, ~5 GB at 6667^2,
  alive after the solve).
"""

import gc
import os
import re
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu.simulator as jsim_mod
import ssrs_tpu_torch
import ssrs_tpu_torch.simulator as tsim_mod
from ssrs_tpu.agents.presence import smooth_presence
from ssrs_tpu_torch.potential import (boundary_masks, solve_potential_mg,
                                     solve_potential_refined)
from ssrs_tpu_torch.potential.direct import interior_residual
from ssrs_tpu_torch.potential.fields import conductivity_hard, speckle

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import LARGE_CONFIG  # noqa: E402

CONFIG = dict(
    LARGE_CONFIG, resolution=957., track_count=8192, track_pkl_budget=0,
    mesh_devices=1,
    # the one-dispatch tail from the start: the JAX package's compacting
    # driver then compiles one program instead of one per bucket
    track_tail_bucket=8192)
GRID = (209, 209)
CASE = 's10d270'
ID = 's10d270_d0_t75_fluidflow_r0'
RTOL, ATOL = 1e-5, 1e-4
# USWTDB-shaped turbines in and around the region's lon/lat box, hub
# heights on both sides of the default minimum (50 m)
_rng = np.random.default_rng(5)
TURBINES = dict(
    t_state=['WY'] * 40, p_name=[f'Project {i % 4}' for i in range(40)],
    p_year=[2005 + i % 15 for i in range(40)],
    t_cap=[1500 + 100 * (i % 10) for i in range(40)],
    t_hh=_rng.uniform(25., 120., 40).round(1),
    t_rd=_rng.uniform(40., 130., 40).round(1),
    xlong=_rng.uniform(-106.5, -103.5, 40), ylat=_rng.uniform(42.5, 44.8, 40))


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    """Every HTTP request of this module is refused: both packages' terrain
    chains then end at the synthetic DEM."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """A solve is many small ops, which crawl beside other test workers on
    a shared thread pool; this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture_turbines(mp):
    """Both simulators get TURBINES instead of the USWTDB answer."""
    class JaxTB(ssrs_tpu.data.TurbinesUSWTB):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dataframe=pd.DataFrame(TURBINES),
                             **kwargs)

    class PortTB(ssrs_tpu_torch.data.TurbinesUSWTB):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dataframe=dict(TURBINES), **kwargs)

    mp.setattr(jsim_mod, 'TurbinesUSWTB', JaxTB)
    mp.setattr(tsim_mod, 'TurbinesUSWTB', PortTB)


def _port(out_dir, **override):
    return ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(out_dir), **{**CONFIG, **override}), device='cpu')


@pytest.fixture(scope='module')
def sims(tmp_path_factory):
    """(JAX run, port run, port run on the JAX package's potential), each
    through ``simulate_tracks()``, the port's past 4096^2 branches on."""
    root = tmp_path_factory.mktemp('large')
    with pytest.MonkeyPatch.context() as mp:
        _fixture_turbines(mp)
        mp.setattr(tsim_mod, '_LARGE_GRID_CELLS', 100 * 100)
        jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
            out_dir=str(root / 'jax'), **CONFIG))
        jax_sim.simulate_tracks()
        port = _port(root / 'port')
        assert not port._device_fields_fit(1)
        port.simulate_tracks()
        shared = root / 'shared' / 'large' / 'data' / 'uniform'
        shared.mkdir(parents=True)
        shutil.copy(os.path.join(jax_sim.mode_data_dir,
                                 f'{ID}_potential.npy'), shared)
        port_shared = _port(root / 'shared')
        port_shared.simulate_tracks()
    return jax_sim, port, port_shared


def _load(sim, name):
    return np.load(os.path.join(sim.mode_data_dir, name))


def _norm_map(counts):
    a = np.asarray(smooth_presence(np.asarray(counts, np.int32), 3),
                   np.float64)
    return a / a.sum()


def test_large_slice_fields(sims):
    jax_sim, port, _ = sims
    assert port.gridsize == jax_sim.gridsize == GRID
    np.testing.assert_array_equal(port.get_terrain_elevation(),
                                  jax_sim.get_terrain_elevation())
    np.testing.assert_allclose(port.get_terrain_slope(),
                               jax_sim.get_terrain_slope(),
                               rtol=RTOL, atol=ATOL)
    d = np.mod(port.get_terrain_aspect().astype(np.float64)
               - jax_sim.get_terrain_aspect(), 360.)
    assert np.minimum(d, 360. - d).max() <= ATOL + RTOL * 360.
    np.testing.assert_allclose(_load(port, f'{CASE}_orograph.npy'),
                               _load(jax_sim, f'{CASE}_orograph.npy'),
                               rtol=RTOL, atol=ATOL)


def _interior(sim):
    return interior_residual(_load(sim, f'{ID}_potential.npy'),
                             np.asarray(sim.load_updrafts(CASE)[0],
                                        np.float32), 0.)


@pytest.mark.parametrize('package', ['jax', 'port'])
def test_large_slice_potential_invariants(sims, package):
    sim = sims[0] if package == 'jax' else sims[1]
    pot = _load(sim, f'{ID}_potential.npy')
    bmask, bvals = boundary_masks(0., GRID)
    assert pot.dtype == np.float32 and pot.shape == GRID
    assert pot.min() >= -1e-3 and pot.max() <= 1000. + 1e-3
    np.testing.assert_array_equal(pot[bmask], bvals[bmask])


def test_large_slice_interior_residual_as_jax(sims):
    """The float64 interior residual of the port's potential at most 1.1x
    the JAX package's. On this field both solves stop along the near-null
    mode (ROADMAP.md section 3): each reads 1.41e-3, past the 2e-4 of the
    WY field of tests/test_torch_potential.py, and sits 274 (of 1000) from
    the direct solve, whose residual is 5.4e-5 (measured on the CPU)."""
    jax_sim, port, _ = sims
    assert _interior(port) <= 1.1 * _interior(jax_sim)


def test_large_slice_refined_record_and_resolve(sims):
    """The port's solve: refined, inside the net, converged; a second
    solve of its field is bitwise the run's potential."""
    port = sims[1]
    rec = {r['phase']: r for r in port.timer.records}['potential']
    assert rec['solver'] == 'refined' and rec['fallback'] is False
    assert rec['rrel'] < 1e-5 and 1 <= rec['passes'] <= rec['vcycles']
    cond = port.load_updrafts(CASE, device=False)[0]
    bmask, bvals = boundary_masks(0., GRID)
    again, rrel = solve_potential_refined(torch.from_numpy(cond), bmask,
                                          bvals, tol=port.potential_tol,
                                          maxcycles=60)
    assert rrel == rec['rrel']
    np.testing.assert_array_equal(again.numpy(),
                                  _load(port, f'{ID}_potential.npy'))


def test_large_slice_counts(sims):
    """Both packages took the counts-only driver; on the JAX package's
    potential the port's counts are within the L1 bound of its counts."""
    jax_sim, port, port_shared = sims
    cj = _load(jax_sim, f'{ID}_counts.npy')
    floor = CONFIG['track_count'] * (port.grid.burnin_length() + 1)
    for sim in (jax_sim, port, port_shared):
        assert not os.path.exists(os.path.join(sim.mode_data_dir,
                                               f'{ID}_tracks.pkl'))
    for sim in (port, port_shared):
        c = _load(sim, f'{ID}_counts.npy')
        assert c.dtype == np.int32 and c.shape == cj.shape == GRID
        assert c.min() >= 0 and c.sum() >= floor
        rec = {r['phase']: r for r in sim.timer.records}['tracks']
        assert rec['recorded'] is False and rec['devices'] == 1
    shared = _load(port_shared, f'{ID}_counts.npy')
    assert np.abs(_norm_map(shared) - _norm_map(cj)).sum() < 0.08


def test_large_turbine_scores_equal_jax_on_shared_counts(sims, tmp_path):
    """With the JAX package's counts in the port's run, both packages
    score the same turbines in the same order."""
    jax_sim = sims[0]
    with pytest.MonkeyPatch.context() as mp:
        _fixture_turbines(mp)
        port = _port(tmp_path)
    shutil.copy(os.path.join(jax_sim.mode_data_dir, f'{ID}_counts.npy'),
                port.mode_data_dir)
    want = jax_sim.get_turbine_presence()
    got = port.get_turbine_presence()
    assert 0 < len(got) == len(want) < len(TURBINES['t_hh'])
    np.testing.assert_array_equal(np.asarray(got.index),
                                  np.asarray(want.index))
    for col in ('t_hh', 'xlong', 'ylat'):
        np.testing.assert_array_equal(np.asarray(got[col]),
                                      np.asarray(want[col]))
    np.testing.assert_allclose(np.asarray(got['presence']),
                               np.asarray(want['presence']), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_load(port, 'summary_presence.npy'),
                               _load(jax_sim, 'summary_presence.npy'),
                               rtol=0, atol=1e-6)


# ---- the branches past 4096^2, on stubs -------------------------------------


PACKAGES = {'jax': (ssrs_tpu.Simulator, ssrs_tpu.Config),
            'port': (ssrs_tpu_torch.Simulator, ssrs_tpu_torch.Config)}
# (grid, the device-resident prep fits one case, the finish window)
GRIDS = [((6667, 6667), False, 1), ((8192, 8192), False, 1),
         ((4096, 4096), True, 3), ((500, 600), True, 3)]


def _stub(package, grid):
    """An object with a grid size, the config fields and the methods the
    branches read, the potential solves replaced by counters of the
    handles held unfinished."""
    cls, config = PACKAGES[package]
    defaults = config()

    class Stub:
        _device_fields_fit = cls._device_fields_fit
        _prepare_potentials = cls._prepare_potentials
        begin_directional_potentials = cls.begin_directional_potentials
        _finish_potential_solve_pair = cls._finish_potential_solve_pair
        _begin_potential_solve = cls._begin_potential_solve
        device = torch.device('cpu')

        def __init__(self):
            self.gridsize = grid
            for name in ('fields_device', 'potential_solver',
                         'potential_fallback_max_unknowns', 'potential_tol',
                         'potential_maxiter', 'track_direction'):
                setattr(self, name, getattr(defaults, name))
            self.held = self.most = 0

        def _potential_batch_cap(self):
            return 1

        def begin_directional_potential(self, updraft, case_id, real_id):
            self.held += 1
            self.most = max(self.most, self.held)
            return case_id

        def finish_directional_potential(self, handle):
            self.held -= 1
            return handle

    return Stub()


@pytest.mark.parametrize('package', ['jax', 'port'])
@pytest.mark.parametrize('grid, fits, depth', GRIDS)
def test_device_fields_guard(package, grid, fits, depth):
    stub = _stub(package, grid)
    assert stub._device_fields_fit(1) is fits
    stub.fields_device = False
    assert stub._device_fields_fit(1) is False


@pytest.mark.parametrize('package', ['jax', 'port'])
@pytest.mark.parametrize('grid, fits, depth', GRIDS)
def test_finish_window(package, grid, fits, depth):
    """At most 3 unfinished solves below 4096^2, 1 past it; every item
    finished, in order."""
    stub = _stub(package, grid)
    items = [(f'c{i}', 0, None) for i in range(7)]
    assert stub._prepare_potentials(items) == [f'c{i}' for i in range(7)]
    assert stub.most == depth and stub.held == 0


def _stalled_handle(package, grid):
    payload = (np.zeros(grid[:1], np.float32), torch.zeros(1), 1.23e-2)
    if package == 'jax':
        return 'refined', payload
    return 'refined', payload, {'rrel': 1.23e-2, 'passes': 10,
                                'vcycles': 82}


_STALL_PATTERN = (r'stalled \(rrel ([0-9.e+-]+)\) on a (\d+x\d+) grid.*'
                  r'at (\d+) unknowns is estimated at ~(\d+) min / '
                  r'~(\d+) GB')


@pytest.mark.parametrize('grid', [(6667, 6667), (8192, 8192)])
def test_stalled_solve_past_the_fallback_cap_raises(grid):
    """Above ``potential_fallback_max_unknowns`` (8M by default) a solve
    stalled above the 5e-3 net raises instead of falling back, with the
    JAX package's grid, rrel and cost estimate."""
    fields = []
    for package in ('jax', 'port'):
        with pytest.raises(RuntimeError) as err:
            _stub(package, grid)._finish_potential_solve_pair(
                _stalled_handle(package, grid))
        match = re.search(_STALL_PATTERN, str(err.value), re.S)
        assert match, package
        fields.append(match.groups())
    assert fields[0] == fields[1]
    assert fields[0][:3] == ('1.23e-02', f'{grid[0]}x{grid[1]}',
                             str(grid[0] * grid[1]))


@pytest.mark.parametrize('package', ['jax', 'port'])
def test_real_stall_past_a_lowered_cap_raises(package):
    """A real refined solve that stalls above the net (the 64x64 speckle
    field at 225 degrees, flagged in both packages) raises past a cap
    lowered below its grid, and returns nothing."""
    grid = (64, 64)
    cond = speckle(np.random.default_rng(225), grid, 0.5)
    stub = _stub(package, grid)
    stub.track_direction = 225.
    stub.potential_fallback_max_unknowns = grid[0] * grid[1] - 1
    handle = stub._begin_potential_solve(cond)
    assert handle[0] == 'refined'
    with pytest.raises(RuntimeError) as err:
        stub._finish_potential_solve_pair(handle)
    match = re.search(_STALL_PATTERN, str(err.value), re.S)
    assert match and float(match.group(1)) > 5e-3
    assert match.groups()[1:3] == ('64x64', '4096')


def _live_tensor_bytes(min_numel):
    return sum(o.numel() * o.element_size() for o in gc.get_objects()
               if isinstance(o, torch.Tensor) and o.numel() >= min_numel)


@pytest.mark.parametrize('solve', [solve_potential_refined,
                                   solve_potential_mg])
def test_solve_leaves_no_reference_cycle(solve):
    shape = (120, 100)
    cond = torch.from_numpy(conductivity_hard(shape, seed=1))
    bmask, bvals = boundary_masks(0., shape)
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        before = _live_tensor_bytes(cond.numel())
        pot, _ = solve(cond, bmask, bvals)
        after = _live_tensor_bytes(cond.numel())
    finally:
        if enabled:
            gc.enable()
    assert after - before == pot.numel() * pot.element_size()
