"""The port's agent sharding (``ssrs_tpu_torch/parallel/mesh.py``), the
multi-case driver's ``devices=`` and the ``Simulator``'s mesh, on the
CPU, with meshes that repeat the CPU device.

- ``pad_to_multiple`` equal to the JAX package's; ``make_mesh`` with
  repeats and without a card.
- Each shard of ``simulate_presence_sharded_compacting`` bit-identical to
  ``simulate_presence_compacting`` on its block of the padded starts and
  flags, with a generator seeded by ``fold_in(seed, i)``; the same for the
  plain ``simulate_presence_sharded`` against ``simulate_presence``.
- Against the JAX package's sharded drivers on the conftest's 8-device
  mesh: statistically (the random streams differ), with the bounds of
  ``tests/test_parallel.py`` (marginal L1 < 0.03, KS < 0.01, 16k agents).
- ``simulate_presence_cases_compacting(devices=...)``: every case
  bit-identical to the single-device driver; a generator on another
  device than its case's raises.
- The ``Simulator`` with ``device=['cpu'] * 4, mesh_devices=4`` against
  ``mesh_devices=1`` and against the JAX package's ``mesh_devices=4`` run
  on the same potential (L1 < 0.08 on the smoothed counts, the bound of
  ``tests/test_compaction.py``), with the JAX package's artifact names;
  ``mesh_devices=1`` gives today's bits.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu_torch
from ssrs_tpu import parallel as jpar
from ssrs_tpu.agents import TrackParams as JParams
from ssrs_tpu.agents.presence import smooth_presence

from ssrs_tpu_torch import parallel as tpar
from ssrs_tpu_torch.agents import get_starting_indices
from ssrs_tpu_torch.agents import simulate as tsim
from ssrs_tpu_torch.core.rng import case_generator, case_seed, fold_in

GRID = (48, 56)
CPU4 = ['cpu'] * 4


def _params(nsteps=120):
    return tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                            burnin=int(min(GRID) / 10), nsteps=nsteps)


def _jparams(nsteps=120):
    return JParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                   burnin=int(min(GRID) / 10), nsteps=nsteps)


def _fields():
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    return updraft, potential


def _starts(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                    axis=1).astype(np.int32)


def _gen(seed):
    gen = torch.Generator(device='cpu')
    gen.manual_seed(seed)
    return gen


@pytest.mark.parametrize('n, multiple', [(5, 8), (5, 5), (100, 8),
                                         (2001, 4), (0, 3)])
def test_pad_to_multiple_equals_jax(n, multiple):
    starts = _starts(n, seed=n)
    got, got_valid = tpar.pad_to_multiple(starts, multiple)
    want, want_valid = jpar.pad_to_multiple(starts, multiple)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got.flags.c_contiguous and got.shape[0] % multiple == 0


def test_make_mesh_repeats_and_cuts():
    assert tpar.make_mesh(devices=CPU4) == (torch.device('cpu'),) * 4
    assert tpar.make_mesh(2, CPU4) == (torch.device('cpu'),) * 2
    assert tpar.make_mesh(0, 'cpu') == (torch.device('cpu'),)
    assert tpar.make_field_mesh(3, CPU4) == (torch.device('cpu'),) * 3


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match='CUDA'):
        tpar.simulate_presence_sharded_compacting(_params(), _starts(8), 1)


def _shards(n_agents, n_dev):
    starts, valid = tpar.pad_to_multiple(_starts(n_agents), n_dev)
    per = len(starts) // n_dev
    return [(starts[i * per:(i + 1) * per], valid[i * per:(i + 1) * per])
            for i in range(n_dev)]


@pytest.mark.parametrize('fluidflow', [True, False])
def test_sharded_compacting_shards_are_the_single_driver(fluidflow):
    """Each shard's map is the single-device compacting driver's on its
    block, bit for bit: their sum is the sharded map, and the sharded steps
    are the most any shard took."""
    updraft, potential = _fields() if fluidflow else (None, None)
    params = _params(nsteps=512)
    seed = 1234
    kw = dict(updraft=updraft, potential=potential, chunk=64,
              min_bucket=128)
    got, steps = tpar.simulate_presence_sharded_compacting(
        params, _starts(2001), seed, mesh=CPU4, **kw)
    want = torch.zeros(GRID, dtype=torch.int32)
    want_steps = []
    for i, (st, va) in enumerate(_shards(2001, 4)):
        p, s = tsim.simulate_presence_compacting(
            params, st, _gen(fold_in(seed, i)), valid=va, **kw)
        want += p
        want_steps.append(s)
    assert got.dtype == torch.int32 and got.shape == GRID
    assert torch.equal(got, want)
    assert steps == max(want_steps)


def test_sharded_compacting_deterministic_and_counts_every_start():
    updraft, potential = _fields()
    params = _params(nsteps=256)
    kw = dict(updraft=updraft, potential=potential, chunk=32, min_bucket=64,
              mesh=CPU4)
    p1, s1 = tpar.simulate_presence_sharded_compacting(
        params, _starts(2048), 5, **kw)
    p2, s2 = tpar.simulate_presence_sharded_compacting(
        params, _starts(2048), 5, **kw)
    assert torch.equal(p1, p2) and s1 == s2
    # every shard below min_bucket (25 agents a shard): each start counts
    small, _ = tpar.simulate_presence_sharded_compacting(
        _params(), _starts(100), 3, min_bucket=64, mesh=CPU4)
    assert int(small.sum()) >= 100
    assert int(small[GRID[0] // 2:, :].sum()) > 0


def _spread_starts(n):
    """Starts over every row: the agents reach the far edge over many
    chunks, so each shard compacts several times."""
    rng = np.random.default_rng(n)
    return np.stack([rng.integers(2, GRID[0] - 2, n),
                     rng.integers(2, GRID[1] - 2, n)], axis=1).astype(np.int32)


def _auto_rule(monkeypatch, rtt, key=None, per_slot=None):
    """``tail_bucket='auto'`` with a round trip of ``rtt`` seconds and, for
    ``key``, a per-slot estimate already made."""
    monkeypatch.setattr(tsim, '_dispatch_overhead', lambda device: rtt)
    monkeypatch.setattr(tsim, '_PER_SLOT',
                        {} if key is None else {key: per_slot})


AUTO_KW = dict(chunk=16, min_bucket=64)


def test_sharded_compacting_tail_bucket_auto_raises(monkeypatch):
    """``'auto'`` runs on the sharded driver (it once raised). With a
    round trip of 0 s it never stops compacting early: the bits of
    tail_bucket=0."""
    updraft, potential = _fields()
    params = _params(nsteps=300)
    kw = dict(updraft=updraft, potential=potential, mesh=CPU4, **AUTO_KW)
    want = tpar.mesh.shard_maps_compacting(params, _spread_starts(4096), 7,
                                      tail_bucket=0, **kw)
    _auto_rule(monkeypatch, 0.)
    got = tpar.mesh.shard_maps_compacting(params, _spread_starts(4096), 7,
                                     tail_bucket='auto', **kw)
    assert torch.equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tsim._PER_SLOT[(params, 16, 'cpu')] > 0


def test_sharded_auto_tail_stops_each_shard_at_its_first_bucket(
        monkeypatch):
    """A round trip longer than every round, with a per-slot cost already
    estimated: each shard stops compacting at the first bucket it packs,
    so its map is the single-device driver's on its block with that
    bucket as tail_bucket."""
    updraft, potential = _fields()
    params = _params(nsteps=300)
    fields = dict(updraft=updraft, potential=potential, **AUTO_KW)
    seed = 7
    firsts = []
    real = tsim._compact_body

    def spy(state, m):
        firsts.append(m)
        return real(state, m)

    blocks = _shards(4096, 4)
    blocks = [(_spread_starts(4096)[i * 1024:(i + 1) * 1024], va)
              for i, (_, va) in enumerate(blocks)]
    for i, (st, va) in enumerate(blocks):
        monkeypatch.setattr(tsim, '_compact_body', spy)
        del firsts[:]
        tsim.simulate_presence_compacting(params, st, _gen(fold_in(seed, i)),
                                          valid=va, tail_bucket=0, **fields)
        blocks[i] = (st, va, firsts[0])
    monkeypatch.setattr(tsim, '_compact_body', real)
    _auto_rule(monkeypatch, 1e9, (params, 16, 'cpu'), 1e-12)
    maps, steps = tpar.mesh.shard_maps_compacting(
        params, _spread_starts(4096), seed, mesh=CPU4, tail_bucket='auto',
        **fields)
    for i, (st, va, first) in enumerate(blocks):
        want, want_steps = tsim.simulate_presence_compacting(
            params, st, _gen(fold_in(seed, i)), valid=va, tail_bucket=first,
            **fields)
        assert torch.equal(maps[i], want) and steps[i] == want_steps


def test_sharded_plain_shards_are_simulate_presence():
    updraft, potential = _fields()
    params = _params()
    got, steps = tpar.simulate_presence_sharded(
        params, _starts(301), 9, updraft=updraft, potential=potential,
        mesh=CPU4, chunk=32)
    want = torch.zeros(GRID, dtype=torch.int32)
    want_steps = []
    for i, (st, va) in enumerate(_shards(301, 4)):
        p, s = tsim.simulate_presence(params, st, _gen(fold_in(9, i)),
                                      updraft=updraft, potential=potential,
                                      chunk=32, valid=va)
        want += p
        want_steps.append(s)
    assert torch.equal(got, want) and steps == max(want_steps)
    # the closure takes the padded batch, as the JAX package's does
    fn = tpar.sharded_presence_fn(params, CPU4, 32)
    starts, valid = tpar.pad_to_multiple(_starts(301), 4)
    again, _ = fn(starts, valid, 9, updraft, potential)
    assert torch.equal(again, got)
    with pytest.raises(ValueError, match='pad'):
        fn(_starts(301), np.ones(301, bool), 9, updraft, potential)


def _marginals_close(got, want):
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    a, b = a / a.sum(), b / b.sum()
    assert np.abs(a.sum(axis=1) - b.sum(axis=1)).sum() < 0.03
    assert np.abs(a.sum(axis=0) - b.sum(axis=0)).sum() < 0.03
    ks = np.abs(np.cumsum(a.sum(axis=1)) - np.cumsum(b.sum(axis=1))).max()
    assert ks < 0.01


def test_sharded_drivers_against_jax():
    """Both sharded drivers on an 8-entry CPU mesh against the JAX
    package's on its 8 virtual devices, 16k agents."""
    assert len(jax.devices()) == 8
    updraft, potential = _fields()
    starts = _starts(16384, seed=7)
    params, jparams = _params(nsteps=512), _jparams(nsteps=512)
    kw = dict(updraft=updraft, potential=potential)
    got, _ = tpar.simulate_presence_sharded_compacting(
        params, starts, 7, mesh=['cpu'] * 8, chunk=64, min_bucket=128, **kw)
    want, _ = jpar.simulate_presence_sharded_compacting(
        jparams, starts, jax.random.key(7), chunk=64, min_bucket=128, **kw)
    assert int(got.sum()) >= 16384
    _marginals_close(got.numpy(), np.asarray(want))
    params, jparams = _params(), _jparams()
    got, _ = tpar.simulate_presence_sharded(params, starts, 7,
                                            mesh=['cpu'] * 8, **kw)
    want, _ = jpar.simulate_presence_sharded(jparams, starts,
                                             jax.random.key(7), **kw)
    _marginals_close(got.numpy(), np.asarray(want))


def test_cases_driver_devices_bit_identical():
    """Three cases over ``devices`` of two entries (case 2 on devices[0]):
    each is the single-device driver's run, bit for bit."""
    updraft, potential = _fields()
    params = _params(nsteps=512)
    tables = [tsim.field_table(params, updraft * (1. + 0.1 * c), potential,
                               'cpu') for c in range(3)]
    starts = _starts(1500)
    kw = dict(chunk=64, min_bucket=128)
    got, steps = tsim.simulate_presence_cases_compacting(
        params, tables, starts, [_gen(c) for c in range(3)],
        devices=['cpu', 'cpu'], **kw)
    for c in range(3):
        want, s = tsim.simulate_presence_compacting(
            params, starts, _gen(c), base_flat=tables[c], **kw)
        assert torch.equal(got[c], want) and steps[c] == s


def test_cases_driver_generator_on_another_device_raises():
    updraft, potential = _fields()
    params = _params()
    table = tsim.field_table(params, updraft, potential, 'cpu')
    with pytest.raises(ValueError, match='generator'):
        tsim.simulate_presence_cases_compacting(
            params, [table, table], _starts(64), [_gen(0), _gen(1)],
            devices=['cuda:0', 'cpu'])


# ---- the Simulator's mesh ---------------------------------------------------

CONFIG = dict(
    run_name='wy_mesh', sim_mode='uniform', sim_seed=11,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(12., 10.),
    resolution=200., uniform_winddirn=270., uniform_windspeed=10.,
    track_direction=0., track_count=4096,
    track_start_region=(1., 11., 1., 2.), track_start_type='random',
    track_max_steps=400, movement_model='fluidflow',
    potential_solver='direct', track_pkl_budget=0, track_tail_bucket=4096)
ID = 's10d270_d0_t75_fluidflow_r0'


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(scope='module')
def mesh_sims(tmp_path_factory):
    """The JAX package on 4 of its devices, then the port on one device
    and on a 4-entry mesh, each in its own out_dir. The port's runs start
    from the JAX run's potential: two direct solves a float32 ulp apart
    move the counts beyond sampling noise (ROADMAP.md section 3)."""
    root = tmp_path_factory.mktemp('mesh')
    jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
        out_dir=str(root / 'jax'), **CONFIG, mesh_devices=4))
    jax_sim.simulate_tracks()
    sims = []
    for name, n in (('one', 1), ('four', 4)):
        data = root / name / CONFIG['run_name'] / 'data' / 'uniform'
        data.mkdir(parents=True)
        shutil.copy(os.path.join(jax_sim.mode_data_dir,
                                 f'{ID}_potential.npy'), data)
        sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=str(root / name), **CONFIG, mesh_devices=n), device=CPU4)
        sim.simulate_tracks()
        sims.append(sim)
    one, four = sims
    four.compute_presence_map()
    return one, four, jax_sim


def _load(sim, name):
    return np.load(os.path.join(sim.mode_data_dir, name))


def _run_starts():
    """The starts a fresh ``Simulator`` of ``CONFIG`` draws first."""
    rows, cols = get_starting_indices(
        CONFIG['track_count'], list(CONFIG['track_start_region']),
        CONFIG['track_start_type'], CONFIG['region_width_km'],
        CONFIG['resolution'], rng=np.random.default_rng(CONFIG['sim_seed']))
    return np.stack([rows, cols], axis=1).astype(np.int32)


def _norm_map(counts):
    a = np.asarray(smooth_presence(np.asarray(counts, np.int32), 3),
                   np.float64)
    return a / a.sum()


def test_simulator_mesh_against_one_device(mesh_sims):
    one, four, jax_sim = mesh_sims
    assert one.mesh == (torch.device('cpu'),)
    assert four.mesh == (torch.device('cpu'),) * 4
    assert one.device == four.device == torch.device('cpu')
    c1, c4 = _load(one, f'{ID}_counts.npy'), _load(four, f'{ID}_counts.npy')
    # the JAX run's potential in all three runs
    for sim in (one, four):
        np.testing.assert_array_equal(_load(sim, f'{ID}_potential.npy'),
                                      _load(jax_sim, f'{ID}_potential.npy'))
    assert c4.dtype == np.int32 and c4.shape == c1.shape
    assert c4.sum() >= CONFIG['track_count'] * (
        four.grid.burnin_length() + 1)
    assert np.abs(_norm_map(c4) - _norm_map(c1)).sum() < 0.08
    # the JAX package's sharded run on 4 of its devices, the same bound
    cj = _load(jax_sim, f'{ID}_counts.npy')
    assert cj.shape == c4.shape
    assert np.abs(_norm_map(c4) - _norm_map(cj)).sum() < 0.08
    names = set(os.listdir(four.mode_data_dir))
    assert names == set(os.listdir(jax_sim.mode_data_dir)) | \
        {'summary_presence.npy'}
    tracks = {r['phase']: r for r in four.timer.records}['tracks']
    assert tracks['devices'] == 4 and not tracks['recorded']


def test_simulator_mesh_is_the_sharded_driver(mesh_sims):
    """The 4-entry mesh's counts are ``simulate_presence_sharded_compacting``
    on the run's starts and fields with the run's tracks seed."""
    _, four, _ = mesh_sims
    want, _ = tpar.simulate_presence_sharded_compacting(
        four._track_params(), _run_starts(),
        case_seed(CONFIG['sim_seed'], 's10d270', 0, 'tracks'),
        updraft=four.load_updrafts('s10d270')[0],
        potential=_load(four, f'{ID}_potential.npy'), mesh=CPU4,
        tail_bucket=4096)
    np.testing.assert_array_equal(_load(four, f'{ID}_counts.npy'),
                                  want.numpy())


def test_simulator_mesh_of_one_is_todays_run(mesh_sims):
    """``mesh_devices=1`` runs the single-device compacting driver with the
    run's generator, as before meshes: bit for bit."""
    one, _, _ = mesh_sims
    want, _ = tsim.simulate_presence_compacting(
        one._track_params(), _run_starts(),
        case_generator(CONFIG['sim_seed'], 's10d270', 0, 'tracks', 'cpu'),
        updraft=one.load_updrafts('s10d270')[0],
        potential=_load(one, f'{ID}_potential.npy'), tail_bucket=4096)
    np.testing.assert_array_equal(_load(one, f'{ID}_counts.npy'),
                                  want.numpy())
    tracks = {r['phase']: r for r in one.timer.records}['tracks']
    assert tracks['devices'] == 1


def test_simulator_batched_over_the_mesh(tmp_path):
    """A two-direction sweep on a 2-entry mesh: the batched driver spreads
    the cases, and each case's counts equal a one-device sweep's."""
    cfg = dict(CONFIG, track_count=512, track_tail_bucket=0)
    runs = {}
    for n in (1, 2):
        sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=str(tmp_path / f'm{n}'), **cfg, mesh_devices=n),
            device=['cpu'] * 2)
        cases = sim.simulate_direction_sweep([0., 90.])
        rec = [r for r in sim.timer.records
               if r['phase'] == 'batched_tracks'][0]
        assert rec['devices'] == n
        runs[n] = {c: np.load(os.path.join(
            sim.mode_data_dir, f'{sim._get_id_string(c, 0)}_counts.npy'))
            for c in cases}
    assert runs[1].keys() == runs[2].keys()
    for c in runs[1]:
        np.testing.assert_array_equal(runs[1][c], runs[2][c])
