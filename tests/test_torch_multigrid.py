"""The port's legacy multigrid (``potential_solver='mg'``) on the CPU,
against the float64 direct solve and the JAX package.

- The JAX package's own multigrid tests (``tests/test_potential.py``),
  ported: the direct solve on a moderate field at ``rtol=2e-3, atol=1.0``;
  self-consistency on a hard field; the uniform gradient.
- Transfers against the JAX module on odd and even shapes: the mask
  coarsening and the prolongation exact (the same float32 operations; JAX
  interleaves by exact 0/1 matmuls, the port by strided assignment); the
  field coarsening within 2 float32 ulps of its values (four values
  summed in another order).
- Whole solves against the JAX module at ``atol=0.02`` on the 0..1000
  range: both stop at the same float32 floor, reached through reductions
  in another order (3e-3 apart measured on these fields).
- The ``Simulator`` with ``'mg'`` in both packages: the same artifact
  names, potentials at the same ``atol``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu_torch
from ssrs_tpu.potential import multigrid as jmg
from ssrs_tpu.potential import solve_potential as jsolve

from ssrs_tpu_torch.potential import (boundary_masks, solve_potential,
                                      solve_potential_direct,
                                      solve_potential_for_direction,
                                      solve_potential_mg)
from ssrs_tpu_torch.potential import multigrid as tmg

from test_potential import _conductivity_hard, _conductivity_moderate

MG_ATOL = 0.02


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    """Every HTTP request of this module is refused: both packages' terrain
    chains then end at the synthetic DEM and their turbine fetches at
    None."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Hundreds of V-cycles of small ops: one torch thread, as in
    tests/test_torch_potential.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mg_matches_direct_on_moderate_contrast():
    shape = (24, 30)
    cond = _conductivity_moderate(shape, seed=2)
    want = solve_potential_direct(cond, 0.)
    got, resid = solve_potential_for_direction(torch.from_numpy(cond), 0.,
                                               tol=1e-7, maxiter=300)
    assert got.dtype == torch.float32 and isinstance(resid, float)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1.0)


def test_mg_self_consistent_on_hard_field():
    """On high-contrast fields the float32 answer may differ from the
    float64 one, but it satisfies its own equations: a small residual, the
    exact boundary, the maximum principle."""
    shape = (24, 30)
    cond = _conductivity_hard(shape, seed=1)
    bmask, bvals = boundary_masks(0., shape)
    got, resid = solve_potential(cond, bmask, bvals, tol=1e-7, maxiter=300,
                                 device='cpu')
    got = got.numpy()
    assert resid < 1e-7 * np.linalg.norm(bvals) + 1e-2
    np.testing.assert_array_equal(got[bmask], bvals[bmask])
    assert got.min() >= -1.0 and got.max() <= 1001.0


def test_mg_uniform_conductivity_gradient():
    shape = (20, 20)
    cond = torch.ones(shape)
    got, _ = solve_potential_for_direction(cond, 0., tol=1e-8, maxiter=300)
    got = got.numpy()
    assert (got[0, :] == 1000.).all() and (got[-1, :] == 0.).all()
    assert (np.diff(got[:, 10]) < 0).all()


def test_mg_numpy_input_needs_a_device():
    bmask, bvals = boundary_masks(0., (8, 9))
    with pytest.raises(ValueError, match='device'):
        solve_potential_mg(np.ones((8, 9), np.float32), bmask, bvals)


@pytest.mark.parametrize('shape', [(7, 9), (8, 10), (24, 30), (33, 47)])
def test_transfers_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape).astype(np.float32)
    got = tmg._coarsen_field(torch.from_numpy(x)).numpy()
    want = np.asarray(jmg._coarsen_field(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2 * 2. ** -23, atol=0)
    mask = rng.random(shape) < 0.1
    np.testing.assert_array_equal(
        tmg._coarsen_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jmg._coarsen_mask(jnp.asarray(mask))))
    e = rng.standard_normal(((shape[0] + 1) // 2,
                             (shape[1] + 1) // 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tmg._prolong(torch.from_numpy(e), shape).numpy(),
        np.asarray(jmg._prolong(jnp.asarray(e), shape)))


def test_levels_match_jax():
    cond = _conductivity_hard((33, 47), seed=4)
    bmask, _ = boundary_masks(45., cond.shape)
    got = tmg.build_levels(torch.from_numpy(cond), torch.from_numpy(bmask))
    want = jmg.build_levels(jnp.asarray(cond), jnp.asarray(bmask))
    assert [lv.shape for lv in got] == [tuple(lv.shape) for lv in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.notb.numpy(), np.asarray(b.notb))


@pytest.mark.parametrize('shape,field,dirn', [
    ((24, 30), _conductivity_moderate, 0.),
    ((25, 31), _conductivity_moderate, 135.),
    ((24, 30), _conductivity_hard, 270.)])
def test_solve_matches_jax(shape, field, dirn):
    cond = field(shape, seed=2)
    bmask, bvals = boundary_masks(dirn, shape)
    got, resid = solve_potential_mg(cond, bmask, bvals, tol=1e-7,
                                    maxcycles=60, device='cpu')
    want, jresid = jsolve(cond, bmask, bvals, tol=1e-7, maxiter=60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MG_ATOL)
    assert abs(resid - float(jresid)) <= 0.5 * float(jresid) + 1e-3


MG_CONFIG = dict(
    run_name='wy_mg', sim_mode='uniform', sim_seed=11,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(12., 10.),
    resolution=200., uniform_winddirn=270., uniform_windspeed=10.,
    track_direction=0., track_count=256,
    track_start_region=(1., 11., 1., 2.), track_max_steps=200,
    movement_model='fluidflow', track_pkl_budget=0, mesh_devices=1,
    track_tail_bucket=4096, potential_maxiter=60)


def _artifacts(sim):
    return sorted(n for n in os.listdir(sim.mode_data_dir)
                  if n.endswith('.npy'))


@pytest.mark.parametrize('solver', ['mg', 'multigrid'])
def test_simulator_mg_matches_jax(tmp_path, solver):
    """A uniform run with the multigrid in both packages: the same
    artifact names; the potentials within ``MG_ATOL``; the port's record
    names the solver and its residual norm, and no fallback."""
    cfg = dict(MG_CONFIG, potential_solver=solver)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
            out_dir=str(tmp_path / 'jax'), **cfg))
        jax_sim.simulate_tracks()
    port = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path / 'port'), **cfg), device='cpu')
    port.simulate_tracks()
    assert _artifacts(port) == _artifacts(jax_sim)
    name = [n for n in _artifacts(port) if n.endswith('_potential.npy')][0]
    got = np.load(os.path.join(port.mode_data_dir, name))
    want = np.load(os.path.join(jax_sim.mode_data_dir, name))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MG_ATOL)
    rec = [r for r in port.timer.records if r['phase'] == 'potential'][0]
    assert rec['solver'] == 'mg' and rec['fallback'] is False
    assert rec['residual_norm'] > 0 and 0 < rec['vcycles'] <= 60


def test_multigrid_with_drw_runs(tmp_path):
    """``'multigrid'`` beside the directed random walk, which solves no
    potential: the run writes counts and no potential."""
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), **dict(MG_CONFIG, potential_solver='multigrid',
                                      movement_model='drw')), device='cpu')
    sim.simulate_tracks()
    names = _artifacts(sim)
    assert any(n.endswith('_drw_r0_counts.npy') for n in names)
    assert not any(n.endswith('_potential.npy') for n in names)
    assert not any(r['phase'] == 'potential' for r in sim.timer.records)
