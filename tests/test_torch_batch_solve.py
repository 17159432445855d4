"""The port's batched refined solve and the ``Simulator``'s batching, on
the CPU, against the port's single solve and the JAX package.

- ``solve_potential_refined_batch`` on the fields of
  ``tests/test_potential.py::test_batched_refined_solve_matches_single``
  (64x80: hard seeds 0 and 7, moderate seed 2): each case within 0.05 of
  the port's single solve and of the JAX package's batched case, rrel
  < 1e-5 (the JAX test's bounds). On the CPU a batched case runs the
  single solve's arithmetic: its V-cycle and pass counts are the single
  solve's, which the tests pin.
- The ``Simulator`` with ``potential_batch > 1``: the JAX package's group
  policy (a power-of-two cap, a lone remainder solved alone), the
  artifact names of the JAX package's batched sweep, each batched
  potential within 0.05 of the port's sequential run on the same field,
  and the residual net case by case.
"""

import os

import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu_torch
from ssrs_tpu import potential as jpot
from ssrs_tpu_torch.potential import (boundary_masks,
                                      solve_potential_refined,
                                      solve_potential_refined_batch)
from ssrs_tpu_torch.potential import lap as tlap
from ssrs_tpu_torch.potential.fields import conductivity_hard, speckle

from test_potential import _conductivity_hard, _conductivity_moderate

SHAPE = (64, 80)
BATCH_ERR = 0.05   # potential units of 0..1000, the JAX test's bound
RREL_MAX = 1e-5


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
    """A solve is many small ops; beside other test workers each op's
    thread-pool barrier waits for busy cores (tests/test_torch_potential.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields():
    return [_conductivity_hard(SHAPE, 0), _conductivity_hard(SHAPE, 7),
            _conductivity_moderate(SHAPE, 2)]


def _solo(cond, dirn=0.):
    bmask, bvals = boundary_masks(dirn, cond.shape)
    stats = {}
    pot, rrel = solve_potential_refined(cond, bmask, bvals, device='cpu',
                                        stats=stats)
    return pot.numpy(), rrel, stats


@pytest.fixture(scope='module')
def batch():
    """The port's batch of the three fields and its stats."""
    bmask, bvals = boundary_masks(0., SHAPE)
    stats = {}
    pots, rrels = solve_potential_refined_batch(_fields(), bmask, bvals,
                                                device='cpu', stats=stats)
    return pots, rrels, stats


@pytest.fixture(scope='module')
def solos():
    return [_solo(c) for c in _fields()]


def test_batch_matches_single_and_jax(batch, solos):
    pots, rrels, _ = batch
    assert pots.dtype == torch.float32 and pots.shape == (3,) + SHAPE
    assert rrels.shape == (3,)
    bmask, bvals = boundary_masks(0., SHAPE)
    jpots, jrrels = jpot.solve_potential_refined_batch(_fields(), bmask,
                                                       bvals)
    jpots = np.asarray(jpots)
    for i, (solo, rrel, _) in enumerate(solos):
        got = pots[i].numpy()
        assert rrels[i] < RREL_MAX and rrel < RREL_MAX
        assert float(jrrels[i]) < RREL_MAX
        assert np.abs(got - solo).max() < BATCH_ERR
        assert np.abs(got - jpots[i]).max() < BATCH_ERR
        np.testing.assert_array_equal(got[bmask], bvals[bmask])


def test_batch_stats_per_case(batch, solos):
    """``stats`` holds one pass and one V-cycle count a case; on the CPU
    they are the single solve's (the easy moderate field beside the hard
    ones takes its own 16 V-cycles, not the hard fields' 26)."""
    _, _, stats = batch
    assert set(stats) == {'passes', 'vcycles'}
    assert stats['passes'] == [s['passes'] for _, _, s in solos]
    assert stats['vcycles'] == [s['vcycles'] for _, _, s in solos]
    assert stats['vcycles'][2] < min(stats['vcycles'][:2])


@pytest.mark.parametrize('order', [(2, 0), (0, 2, 1)])
def test_batch_mixes_fields_with_and_without_islands(order, solos):
    """The moderate field has no floating island (``num == 1``); the hard
    ones have many. Any order of them solves each case as alone."""
    fields = _fields()
    bmask, bvals = boundary_masks(0., SHAPE)
    ks = [tlap.island_labels(fields[i], bmask)[1] for i in order]
    assert 0 in ks and max(ks) > 0
    stats = {}
    pots, rrels = solve_potential_refined_batch(
        [torch.from_numpy(fields[i]) for i in order], bmask, bvals,
        stats=stats)
    for j, i in enumerate(order):
        solo, rrel, solo_stats = solos[i]
        assert np.abs(pots[j].numpy() - solo).max() < BATCH_ERR
        assert rrels[j] < RREL_MAX
        assert stats['vcycles'][j] == solo_stats['vcycles']


def test_batch_without_any_island():
    """A batch whose every case has no island builds no island
    structure."""
    fields = [_conductivity_moderate(SHAPE, s) for s in (2, 3)]
    bmask, bvals = boundary_masks(90., SHAPE)
    pots, rrels = solve_potential_refined_batch(np.stack(fields), bmask,
                                                bvals, device='cpu')
    for i, cond in enumerate(fields):
        solo, rrel, _ = _solo(cond, 90.)
        assert rrels[i] < RREL_MAX
        assert np.abs(pots[i].numpy() - solo).max() < BATCH_ERR


def test_batch_is_bitwise_repeatable(batch):
    pots, rrels, _ = batch
    bmask, bvals = boundary_masks(0., SHAPE)
    again, rrels2 = solve_potential_refined_batch(
        torch.from_numpy(np.stack(_fields())), bmask, bvals)
    assert torch.equal(pots, again)
    np.testing.assert_array_equal(rrels, rrels2)


def test_batch_stalled_case_is_its_own():
    """The 225-degree speckle field that the single solve flags
    (tests/test_torch_potential.py::test_refined_fuzz_directions) is
    flagged inside a batch too, and the hard field beside it converges."""
    bad = speckle(np.random.default_rng(225), (64, 64), 0.5)
    good = conductivity_hard((64, 64), seed=1)
    bmask, bvals = boundary_masks(225., (64, 64))
    _, rrels = solve_potential_refined_batch([bad, good], bmask, bvals,
                                             device='cpu')
    assert rrels[0] > 5e-3 and rrels[1] < RREL_MAX
    assert rrels[0] == _solo(bad, 225.)[1]


def test_batch_numpy_input_needs_a_device():
    bmask, bvals = boundary_masks(0., (8, 9))
    with pytest.raises(ValueError, match='device'):
        solve_potential_refined_batch([np.ones((8, 9), np.float32)] * 2,
                                      bmask, bvals)


# ---- the Simulator ---------------------------------------------------------


SIM_CONFIG = dict(
    sim_mode='uniform', southwest_lonlat=(-106.21, 42.78), resolution=200.,
    movement_model='fluidflow', sim_seed=5, region_width_km=(10., 8.),
    track_count=64, track_start_region=(1., 9., 1., 2.),
    track_max_steps=60, track_pkl_budget=0, track_tail_bucket=4096,
    mesh_devices=1)
SWEEP = [0., 45., 90., 135., 180.]


def _port_sim(out, **kw):
    return ssrs_tpu_torch.Simulator(
        ssrs_tpu_torch.Config(out_dir=str(out), **{**SIM_CONFIG, **kw}),
        device='cpu')


def _artifacts(sim):
    return sorted(n for n in os.listdir(sim.mode_data_dir)
                  if n.endswith('.npy'))


def test_potential_batch_cap_policy(tmp_path, monkeypatch):
    """``Config.potential_batch``: 0 = auto = off, 1 = off, n > 1 = n while
    the memory envelope allows (``tests/test_simulator.py``), and the cap
    falls as the grid grows."""
    sim = _port_sim(tmp_path, run_name='cap', region_width_km=(12., 10.),
                    track_count=10)
    assert tuple(sim.gridsize) == (50, 60)
    for pb, want in ((0, 1), (1, 1), (6, 6)):
        monkeypatch.setattr(sim, 'potential_batch', pb)
        assert sim._potential_batch_cap() == want
    for solver in ('direct', 'mg'):
        monkeypatch.setattr(sim, 'potential_solver', solver)
        assert sim._potential_batch_cap() == 1
    monkeypatch.setattr(sim, 'potential_solver', 'auto')
    monkeypatch.setattr(sim, 'potential_batch', 1 << 20)
    caps = []
    for side in (50, 500, 5000, 50000):
        monkeypatch.setattr(sim, 'gridsize', (side, side))
        caps.append(sim._potential_batch_cap())
    assert caps == sorted(caps, reverse=True) and caps[-1] == 1
    assert caps[0] > caps[1] > caps[2]


@pytest.fixture(scope='module')
def sweeps(tmp_path_factory):
    """A five-direction sweep at potential_batch=4 through both packages,
    and the port's sequential sweep; the JAX package's batched solves
    recorded by the number of fields each got."""
    root = tmp_path_factory.mktemp('batched_sweep')
    jax_groups = []
    real = jpot.solve_potential_refined_batch

    def spy(conds, *args, **kwargs):
        jax_groups.append(len(conds))
        return real(conds, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        mp.setattr(jpot, 'solve_potential_refined_batch', spy)
        jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
            out_dir=str(root / 'jax'),
            **{**SIM_CONFIG, 'run_name': 'sweep', 'potential_batch': 4}))
        jax_sim.simulate_direction_sweep(SWEEP)
    port = _port_sim(root / 'port', run_name='sweep', potential_batch=4)
    port.simulate_direction_sweep(SWEEP)
    seq = _port_sim(root / 'seq', run_name='sweep')
    seq.simulate_direction_sweep(SWEEP)
    return jax_sim, jax_groups, port, seq


def test_batched_sweep_groups_like_jax(sweeps):
    """Five uncached items at cap 4: one group of four, the fifth alone,
    in both packages."""
    _, jax_groups, port, _ = sweeps
    assert jax_groups == [4]
    recs = [r for r in port.timer.records if r['phase'] == 'potential']
    assert [r.get('batch') for r in recs] == [4, 4, 4, 4, None]
    group = recs[:4]
    assert len({r['group_seconds'] for r in group}) == 1
    for r in group:
        assert r['solver'] == 'refined' and r['rrel'] < RREL_MAX
        assert r['seconds'] >= r['group_seconds'] / 4
        assert r['vcycles'] > 0 and r['passes'] > 0


def test_batched_sweep_artifacts_and_potentials(sweeps):
    """The batched sweep writes the JAX package's artifact names, and each
    batched potential is within 0.05 of the sequential run's on the same
    field."""
    jax_sim, _, port, seq = sweeps
    assert _artifacts(port) == _artifacts(jax_sim) == _artifacts(seq)
    names = [n for n in _artifacts(port) if n.endswith('_potential.npy')]
    assert len(names) == len(SWEEP)
    for name in names:
        a = np.load(os.path.join(port.mode_data_dir, name))
        b = np.load(os.path.join(seq.mode_data_dir, name))
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() < BATCH_ERR


def test_batched_prep_falls_back_case_by_case(tmp_path):
    """A batch that holds the non-converging 225-degree speckle field: that
    case alone falls back to the direct solve; its neighbour keeps the
    refined potential, and a lone third item takes the single solve."""
    sim = _port_sim(tmp_path, run_name='net', region_width_km=(12.8, 12.8),
                    track_direction=225., potential_batch=2, track_count=10)
    assert tuple(sim.gridsize) == (64, 64)
    bad = speckle(np.random.default_rng(225), (64, 64), 0.5)
    good = conductivity_hard((64, 64), seed=1)
    items = [(bad, 'bad', 0), (good, 'good', 0), (good * 1.5, 'third', 0)]
    pots = [sim.finish_directional_potential(h)
            for h in sim.begin_directional_potentials(items)]
    recs = {r['id'].split('_')[0]: r for r in sim.timer.records
            if r['phase'] == 'potential'}
    assert recs['bad']['fallback'] is True and recs['bad']['batch'] == 2
    assert recs['bad']['rrel'] > 5e-3
    assert recs['good']['fallback'] is False and recs['good']['batch'] == 2
    assert 'batch' not in recs['third']
    solo, _, _ = _solo(good, 225.)
    assert np.abs(pots[1] - solo).max() < BATCH_ERR
    from ssrs_tpu_torch.potential import solve_potential_direct
    np.testing.assert_array_equal(pots[0], solve_potential_direct(bad, 225.))
