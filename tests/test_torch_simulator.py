"""The port's whole slice against the JAX package, and its guards.

Both ``Simulator``s run the tests' WY config (12x10 km at 200 m, 50x60)
in uniform mode with the direct potential solve, each in its own
``out_dir``, with every network request refused (offline, the JAX
package's terrain chain ends at the same synthetic DEM as the port's).

- DEM exact; slope, aspect and updraft at ``rtol=1e-5, atol=1e-4``
  (transcendentals differ by ulps between XLA and torch).
- Potentials at ``atol=1e-3`` on their 0..1000 range: the updrafts
  differ by ulps, and the solve carries that into the potential (2 float32
  ulps at 1000 measured).
- Counts: half of this grid is below the updraft threshold, and where the
  conductivity is high the potential is flat to a few float32 ulps, so
  moves there follow ulp-level noise of the potential. The JAX engine
  alone, fed the port's potential instead of its own, moves its
  smoothed map by L1 0.10-0.11 (between seeds: 0.03-0.04). So the counts
  are held to the L1 bound of ``tests/test_compaction.py`` (0.08) when
  the port runs on the JAX package's cached potential (the artifacts are
  shared by name and format), and, on its own potential, to the mass and
  support of the JAX counts.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu_torch
from ssrs_tpu.agents.presence import smooth_presence
from ssrs_tpu_torch.agents import fused_chunk
from ssrs_tpu_torch.agents.fused_step import launch_count, \
    reset_launch_count

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(
    run_name='wy_test', sim_mode='uniform', sim_seed=11,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(12., 10.),
    resolution=200., uniform_winddirn=270., uniform_windspeed=10.,
    track_direction=0., track_count=4096,
    track_start_region=(1., 11., 1., 2.), track_start_type='random',
    track_max_steps=400, movement_model='fluidflow',
    potential_solver='direct', track_pkl_budget=0, mesh_devices=1,
    # the one-dispatch tail from the start: the JAX package's
    # simulate_presence_compacting then compiles one program instead of
    # one per bucket (a cold compile per bucket costs seconds on the CPU)
    track_tail_bucket=4096)
CASE = 's10d270'
ID = 's10d270_d0_t75_fluidflow_r0'
RTOL, ATOL = 1e-5, 1e-4


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module')
def sims(tmp_path_factory):
    root = tmp_path_factory.mktemp('slice')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
            out_dir=str(root / 'jax'), **CONFIG))
        jax_sim.simulate_tracks()
    reset_launch_count()
    fused_chunk.reset_launch_count()
    port = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(root / 'port'), **CONFIG), device='cpu')
    port.simulate_tracks()
    port.compute_presence_map()
    # (per-step kernel, chunk kernel) launches
    launches = (launch_count(), fused_chunk.launch_count())
    # a second port run whose cache holds the JAX package's potential
    shared = root / 'shared' / 'wy_test' / 'data' / 'uniform'
    shared.mkdir(parents=True)
    shutil.copy(os.path.join(jax_sim.mode_data_dir, f'{ID}_potential.npy'),
                shared)
    port_shared = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(root / 'shared'), **CONFIG), device='cpu')
    port_shared.simulate_tracks()
    return jax_sim, port, port_shared, launches


def _load(sim, name):
    return np.load(os.path.join(sim.mode_data_dir, name))


def _norm_map(counts):
    a = np.asarray(smooth_presence(np.asarray(counts, np.int32), 3),
                   np.float64)
    return a / a.sum()


def test_slice_fields(sims):
    jax_sim, port, _, _ = sims
    assert port.gridsize == jax_sim.gridsize == (50, 60)
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


def test_slice_potential(sims):
    jax_sim, port, _, _ = sims
    pj = _load(jax_sim, f'{ID}_potential.npy')
    pt = _load(port, f'{ID}_potential.npy')
    assert pt.dtype == pj.dtype == np.float32
    np.testing.assert_allclose(pt, pj, rtol=0., atol=1e-3)


def test_slice_counts(sims):
    jax_sim, port, port_shared, _ = sims
    cj = _load(jax_sim, f'{ID}_counts.npy')
    ct = _load(port, f'{ID}_counts.npy')
    cs = _load(port_shared, f'{ID}_counts.npy')
    for c in (ct, cs):
        assert c.dtype == np.int32 and c.shape == cj.shape
        assert c.min() >= 0
        # every track: at least the burn-in steps plus the start
        assert c.sum() >= CONFIG['track_count'] * (
            port.grid.burnin_length() + 1)
    # on the same potential: the statistical bound
    assert np.abs(_norm_map(cs) - _norm_map(cj)).sum() < 0.08
    # on its own potential: the same mass and support
    assert abs(float(ct.sum()) / cj.sum() - 1.) < 0.05
    assert ((ct > 0) == (cj > 0)).mean() > 0.9


def test_slice_artifacts(sims):
    jax_sim, port, _, launches = sims
    names = set(os.listdir(port.mode_data_dir))
    for name in (f'{CASE}_orograph.npy', f'{ID}_potential.npy',
                 f'{ID}_counts.npy', 'summary_presence.npy'):
        assert name in names
        assert name in os.listdir(jax_sim.mode_data_dir) or \
            name == 'summary_presence.npy'
    summary = _load(port, 'summary_presence.npy')
    assert summary.dtype == np.float32 and summary.max() == 1.0
    assert os.path.isfile(os.path.join(port.out_dir, 'wy_test',
                                       'phase_timings.json'))
    # CPU tensors never launch the CUDA kernels
    assert launches == (0, 0)


def test_port_imports_no_jax():
    code = ('import sys, ssrs_tpu_torch, ssrs_tpu_torch.simulator; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "ssrs_tpu")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True)


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=str(tmp_path), **CONFIG))


@pytest.mark.parametrize('override', [
    dict(sim_mode='seasonal'), dict(sim_mode='snapshot'),
    dict(sim_mode='snapshot', thermals_realization_count=1),
    dict(mesh_devices=2, movement_model='drw'),
    dict(potential_solver='mg'), dict(track_presence_impl='scatter'),
    dict(mesh_devices=2), dict(track_step_impl='xla'),
    dict(potential_batch=2),
])
def test_out_of_slice_configs_raise(tmp_path, override):
    cfg = ssrs_tpu_torch.Config(out_dir=str(tmp_path),
                                **{**CONFIG, **override})
    with pytest.raises(NotImplementedError, match='ROADMAP|engine'):
        ssrs_tpu_torch.Simulator(cfg, device='cpu')


def test_refined_run_matches_jax_auto_and_direct(sims, tmp_path):
    """The default potential_solver='auto' runs the port's refined solver
    on the run's device: a whole run on the CPU, its potential within 1.0
    (of 1000) of the JAX package's 'auto' potential and of the direct
    solve (JAX's 'auto' reads 0.108 from the direct solve here)."""
    from ssrs_tpu.potential import solve_potential_refined as jrefined
    jax_sim, port, _, _ = sims
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), **{**CONFIG, 'potential_solver': 'auto'}),
        device='cpu')
    sim.simulate_tracks()
    rec = {r['phase']: r for r in sim.timer.records}['potential']
    assert rec['solver'] == 'refined' and rec['fallback'] is False
    assert rec['rrel'] < 1e-5 and 1 <= rec['passes'] <= rec['vcycles']
    pot = _load(sim, f'{ID}_potential.npy')
    bmask, bvals = ssrs_tpu_torch.potential.boundary_masks(0., pot.shape)
    want_jax, _ = jrefined(np.asarray(jax_sim.load_updrafts(CASE)[0]),
                           bmask, bvals)
    for want in (np.asarray(want_jax), _load(port, f'{ID}_potential.npy')):
        assert np.abs(pot.astype(np.float64) - want).max() < 1.0
    # a second run reads the cache
    again = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), **{**CONFIG, 'potential_solver': 'auto'}),
        device='cpu')
    again.simulate_tracks()
    rec = {r['phase']: r for r in again.timer.records}['potential']
    assert rec['solver'] == 'cache' and rec['rrel'] is None


def _stalled_solver(garbage):
    return lambda *a, **k: (torch.from_numpy(garbage), 0.5)


def test_potential_fallback(sims, monkeypatch, capsys):
    """The residual net: a refined solve reporting rrel above 5e-3 is
    discarded for the float64 direct solve (forced with a stub that
    returns garbage and a stalled residual)."""
    from ssrs_tpu_torch.potential.direct import solve_potential_direct
    port = sims[1]
    monkeypatch.setattr(port, 'potential_solver', 'auto')
    rng = np.random.default_rng(0)
    cond = rng.random(port.gridsize).astype(np.float32)
    cond[cond < 0.5] = 0.0
    garbage = np.full(port.gridsize, 1e6, np.float32)
    monkeypatch.setattr(ssrs_tpu_torch.potential, 'solve_potential_refined',
                        _stalled_solver(garbage))
    handle = port._begin_potential_solve(cond)
    got, dev = port._finish_potential_solve_pair(handle)
    out = capsys.readouterr().out
    assert 'falling back to the f64 direct solver' in out
    assert dev is None and handle[-1]['fallback'] is True
    want = solve_potential_direct(cond, port.track_direction)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_potential_tol_threads_to_refined_solver(sims, monkeypatch):
    """Config.potential_tol and potential_maxiter reach the refined
    solver."""
    port = sims[1]
    seen = {}

    def fake_solve(cond, bmask, bvals, tol=1e-7, maxcycles=60, **kw):
        seen.update(tol=tol, maxcycles=maxcycles, device=cond.device)
        return torch.zeros(port.gridsize), 1e-9

    monkeypatch.setattr(ssrs_tpu_torch.potential, 'solve_potential_refined',
                        fake_solve)
    monkeypatch.setattr(port, 'potential_solver', 'refined')
    monkeypatch.setattr(port, 'potential_tol', 3e-4)
    cond = np.random.default_rng(0).random(port.gridsize).astype(np.float32)
    port._solve_potential(cond)
    assert seen == dict(tol=3e-4, maxcycles=60, device=torch.device('cpu'))
    monkeypatch.setattr(port, 'potential_maxiter', 17)
    port._solve_potential(cond)
    assert seen['maxcycles'] == 17


def test_potential_fallback_size_cap(sims, monkeypatch):
    """Above Config.potential_fallback_max_unknowns a stall raises with
    the cost estimate; <= 0 lifts the cap."""
    port = sims[1]
    monkeypatch.setattr(port, 'potential_solver', 'auto')
    rng = np.random.default_rng(0)
    cond = rng.random(port.gridsize).astype(np.float32)
    garbage = np.full(port.gridsize, 1e6, np.float32)
    monkeypatch.setattr(ssrs_tpu_torch.potential, 'solve_potential_refined',
                        _stalled_solver(garbage))
    monkeypatch.setattr(port, 'potential_fallback_max_unknowns', 100)
    with pytest.raises(RuntimeError, match='estimated'):
        port._solve_potential(cond)
    monkeypatch.setattr(port, 'potential_fallback_max_unknowns', 0)
    got = port._solve_potential(cond)
    assert np.isfinite(got).all()


def test_fallback_cost_estimate_monotone():
    """The cost model reproduces its anchors, grows superlinearly, and
    equals the JAX package's."""
    from ssrs_tpu.potential.direct import fallback_cost_estimate as jcost
    from ssrs_tpu_torch.potential import fallback_cost_estimate
    s512, g512 = fallback_cost_estimate(512 * 512)
    assert abs(s512 - 4.9) < 1e-6 and abs(g512 - 0.94) < 1e-6
    s2048, g2048 = fallback_cost_estimate(2048 * 2048)
    assert 250 < s2048 < 500
    assert 8 < g2048 < 25
    s8192, _ = fallback_cost_estimate(8192 * 8192)
    assert s8192 > 3600
    for n in (1, 512 * 512, 8192 * 8192):
        assert fallback_cost_estimate(n) == jcost(n)


def test_config_json_roundtrip_between_packages(tmp_path):
    """A run JSON from either package loads into the other."""
    cfg = ssrs_tpu.Config(**CONFIG)
    cfg.to_json(str(tmp_path / 'j.json'))
    back = ssrs_tpu_torch.Config.from_json(str(tmp_path / 'j.json'))
    assert back.asdict() == cfg.asdict()
    assert [f for f in ssrs_tpu_torch.Config.__dataclass_fields__] == \
        [f for f in ssrs_tpu.Config.__dataclass_fields__]
