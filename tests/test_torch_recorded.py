"""The port's recorded-track path against the JAX package's.

- Track builders: the port's C++ ``TrackBuilder``, its Python loop and
  ``ssrs_tpu.native.TrackBuilder`` give the same tracks from the same
  emissions.
- Drivers (``simulate_tracks_recorded`` and ``simulate_presence`` with
  ``record_tracks``): the invariants of ``tests/test_agents.py`` (starts,
  grid, lengths, boundary deaths, neighbour moves after burn-in), and
  counts equal to the recount of the tracks, exactly.
- Against JAX: the two packages draw from different generators (threefry
  and Philox never agree), so smoothed, normalized presence maps are held
  to the L1 bound of ``tests/test_compaction.py`` (0.08) on one table.
- ``compute_presence_counts``: exactly JAX's, the int16 wrap of a cell
  above 32767 visits included.
- The ``Simulator``: the default budget records ``_tracks.pkl``; its
  recount equals ``_counts.npy``; on the JAX package's cached potential
  its counts are within L1 0.08 of ``ssrs_tpu.Simulator``'s.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu.native as jnative
import ssrs_tpu_torch
from ssrs_tpu.agents import presence as jpresence
from ssrs_tpu.agents import simulate as jsim
from ssrs_tpu.agents.moves import directional_probs

from ssrs_tpu_torch import native as tnative
from ssrs_tpu_torch.agents import presence as tpresence
from ssrs_tpu_torch.agents import simulate as tsim

GRID = (48, 56)
BURNIN = 4
L1_BOUND = 0.08
WY = dict(
    run_name='wy_rec', sim_mode='uniform', sim_seed=11,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(12., 10.),
    resolution=200., uniform_winddirn=270., uniform_windspeed=10.,
    track_direction=0., track_start_region=(1., 11., 1., 2.),
    track_start_type='random', track_max_steps=400,
    movement_model='fluidflow', potential_solver='direct', mesh_devices=1)
ID = 's10d270_d0_t75_fluidflow_r0'


def _fields():
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    return updraft, potential


def _starts(n, seed, rows=(3, 6)):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(*rows, n), rng.integers(18, 38, n)],
                    axis=1).astype(np.int32)


def _params(pkg, nsteps):
    return pkg.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                           burnin=BURNIN, nsteps=nsteps)


def _table():
    """The JAX package's f32 table for the test fields: both packages'
    drivers run on it."""
    up, pot = _fields()
    return jsim.prepared_weights(jnp.asarray(up), jnp.asarray(pot),
                                 jnp.asarray(directional_probs(0.)),
                                 'float32')


def _emissions(rng, n_agents, chunks):
    """Chunks of emissions as a compacting driver makes them: the alive
    flags are a prefix within each agent's column, the batch shrinks and
    the ids are permuted between chunks."""
    ids = rng.permutation(n_agents).astype(np.int32)
    out = []
    for t_len in chunks:
        b = ids.shape[0]
        pos = rng.integers(0, 300, (t_len, b, 2)).astype(np.int16)
        steps = rng.integers(0, t_len + 1, b)
        alive = np.arange(t_len)[:, None] < steps[None, :]
        out.append((pos, alive, ids.copy()))
        ids = rng.permutation(ids)[:max(b * 2 // 3, 1)]
    return out


def test_trackbuilders_agree():
    if not tnative.native_available() or not jnative.native_available():
        pytest.skip('no C++ toolchain available')
    rng = np.random.default_rng(3)
    n = 400
    starts = rng.integers(0, 300, (n, 2)).astype(np.int16)
    builders = [tnative.TrackBuilder(starts), tnative.PyTrackBuilder(starts),
                jnative.TrackBuilder(starts)]
    assert [b.kind for b in builders[:2]] == ['native', 'python']
    for pos, alive, ids in _emissions(rng, n, [7, 16, 1, 16, 5]):
        for b in builders:
            b.append_chunk(pos, alive, ids)
    outs = [b.export() for b in builders]
    assert all(len(o) == n for o in outs)
    for tracks in zip(*outs):
        for t in tracks:
            assert t.dtype == np.int16 and t.flags.c_contiguous
            np.testing.assert_array_equal(t, tracks[0])
    assert sum(len(t) for t in outs[0]) > 2 * n


def test_trackbuilders_with_no_agents():
    """No agents, no tracks: ``ssrs_tpu.native.TrackBuilder`` exports
    one empty track here (``np.split`` of an empty array), the port's
    builders none."""
    starts = np.zeros((0, 2), np.int16)
    assert tnative.PyTrackBuilder(starts).export() == []
    if tnative.native_available():
        assert tnative.TrackBuilder(starts).export() == []


def test_builder_rejects_bad_ids():
    builder = tnative.PyTrackBuilder(np.zeros((3, 2), np.int16))
    with pytest.raises(ValueError):
        builder.append_chunk(np.zeros((2, 2, 2), np.int16),
                             np.ones((2, 2), bool), np.array([0, 3]))


def _run_driver(driver, n, seed, nsteps, chunk=8, min_bucket=64):
    """(presence, track list) of one of the port's recording drivers on
    the test fields."""
    up, pot = _fields()
    gen = torch.Generator().manual_seed(seed)
    params = _params(tsim, nsteps)
    # starts spread over the rows: the northward drift ends the tracks at
    # different steps, so the batch shrinks chunk by chunk
    starts = _starts(n, seed, rows=(3, GRID[0] - 8))
    if driver == 'recorded':
        presence, tracks, *_ = tsim.simulate_tracks_recorded(
            params, starts, gen, updraft=up, potential=pot, chunk=chunk,
            min_bucket=min_bucket)
    else:
        presence, steps, arr, lengths = tsim.simulate_presence(
            params, starts, gen, updraft=up, potential=pot,
            record_tracks=True)
        assert steps == nsteps
        assert tuple(arr.shape) == (nsteps + 1, n, 2)
        assert arr.dtype == torch.int16 and lengths.dtype == torch.int32
        arr, lengths = arr.numpy(), lengths.numpy()
        tracks = [arr[:lengths[i], i] for i in range(n)]
    return presence, tracks, starts


@pytest.mark.parametrize('driver', ['recorded', 'presence_record'])
def test_recorded_invariants(driver):
    nsteps = 150
    n = 1000
    tsim.reset_flush_count()
    presence, tracks, starts = _run_driver(driver, n, 5, nsteps)
    # the recording driver flushed before each compaction (1000 agents
    # shrink through several buckets), and at the end
    assert tsim.flush_count() >= (3 if driver == 'recorded' else 1)
    nrow, ncol = GRID
    lengths = np.array([len(t) for t in tracks])
    assert len(tracks) == n
    assert (lengths >= BURNIN + 1).all() and (lengths <= nsteps + 1).all()
    assert presence.dtype == torch.int32
    assert int(presence.sum()) == lengths.sum()
    # the counts map equals the recount of the tracks, cell for cell
    recount = tpresence.compute_presence_counts(tracks, GRID, device='cpu')
    np.testing.assert_array_equal(presence.numpy(), recount)
    for i, t in enumerate(tracks):
        assert t.dtype == np.int16 and t.shape[1] == 2
        np.testing.assert_array_equal(t[0], starts[i])
        assert t[:, 0].min() >= 0 and t[:, 0].max() <= nrow - 1
        assert t[:, 1].min() >= 0 and t[:, 1].max() <= ncol - 1
        if len(t) < nsteps + 1:  # died before the cap: on the boundary
            assert t[-1, 0] in (0, nrow - 1) or t[-1, 1] in (0, ncol - 1)
        after = np.diff(t[BURNIN + 1:].astype(np.int32), axis=0)
        assert after.size == 0 or np.abs(after).max() <= 1
    assert (lengths < nsteps + 1).sum() > n // 2
    assert lengths.min() < 20 < lengths.max()


def test_recorded_counts_equal_compacting_counts():
    """The recording driver runs the compacting driver's loop (same
    chunks, buckets and compactions, so the same draws): from one
    generator seed both give the same counts and step count."""
    up, pot = _fields()
    params = _params(tsim, 150)
    starts = _starts(1000, 6, rows=(3, GRID[0] - 8))
    run = tsim.simulate_tracks_recorded(params, starts,
                                        torch.Generator().manual_seed(4),
                                        updraft=up, potential=pot, chunk=8,
                                        min_bucket=64)
    presence, steps = tsim.simulate_presence_compacting(
        params, starts, torch.Generator().manual_seed(4), updraft=up,
        potential=pot, chunk=8, min_bucket=64)
    assert torch.equal(run.presence, presence) and run.steps == steps
    assert run.builder in ('native', 'python') and run.build_seconds >= 0.


def _norm_map(counts):
    a = np.asarray(jpresence.smooth_presence(np.asarray(counts, np.int32),
                                             3), np.float64)
    return a / a.sum()


@pytest.mark.parametrize('driver', ['recorded', 'presence_record'])
def test_recorded_matches_jax_statistically(driver):
    n, nsteps = 3000, 200
    starts = _starts(n, 8)
    table = _table()
    up, pot = _fields()
    base = tsim.weights_from_numpy(np.asarray(table), 'cpu')
    gen = torch.Generator().manual_seed(9)
    if driver == 'recorded':
        pj, tj = jsim.simulate_tracks_recorded(
            _params(jsim, nsteps), starts, jax.random.key(9), updraft=up,
            potential=pot, chunk=128, min_bucket=1024)
        pt, tt, *_ = tsim.simulate_tracks_recorded(
            _params(tsim, nsteps), starts, gen, base_flat=base, chunk=64,
            min_bucket=256)
        assert len(tj) == len(tt) == n
        lj, lt = (np.mean([len(t) for t in x]) for x in (tj, tt))
        assert abs(lt / lj - 1.) < 0.1
    else:
        pj, _, _, lj = jsim.simulate_presence(
            _params(jsim, nsteps), starts, jax.random.key(9), updraft=up,
            potential=pot, record_tracks=True)
        pt, _, _, lt = tsim.simulate_presence(
            _params(tsim, nsteps), starts, gen, base_flat=base,
            record_tracks=True)
        assert abs(float(lt.double().mean()) / float(np.mean(lj)) - 1.) < 0.1
    assert np.abs(_norm_map(pj) - _norm_map(pt.numpy())).sum() < L1_BOUND


def test_presence_driver_without_recording_counts_its_tracks():
    """The chunked driver and the recording one run the same steps from
    the same generator state: the same counts."""
    up, pot = _fields()
    params = _params(tsim, 150)
    starts = _starts(500, 4)
    p1, s1 = tsim.simulate_presence(params, starts,
                                    torch.Generator().manual_seed(2),
                                    updraft=up, potential=pot, chunk=150)
    p2, s2, _, lengths = tsim.simulate_presence(
        params, starts, torch.Generator().manual_seed(2), updraft=up,
        potential=pot, record_tracks=True)
    assert torch.equal(p1, p2)
    assert s1 == s2 == 150 and int(lengths.sum()) == int(p1.sum())


def test_presence_driver_without_table_raises():
    """The name is from when the driver refused a run without a table; it
    is kept so the test's history stays in one line. Now, without a table
    and without an updraft, the driver does not raise: it runs the
    directed random walk. Every agent counts its start and each step,
    since none can reach the boundary in 10 steps."""
    params = _params(tsim, 10)
    presence, steps = tsim.simulate_presence(
        params, _starts(4, 1), torch.Generator().manual_seed(0))
    assert steps == 10 and int(presence.sum()) == 4 * 11


def _track_list(seed):
    rng = np.random.default_rng(seed)
    tracks = []
    for _ in range(60):
        length = int(rng.integers(1, 200))
        tracks.append(np.stack([rng.integers(0, GRID[0], length),
                                rng.integers(0, GRID[1], length)],
                               axis=1).astype(np.int16))
    # one cell visited 40,000 times: above int16's 32767, it wraps
    tracks.append(np.tile(np.array([[7, 9]], np.int16), (40_000, 1)))
    return tracks


def test_compute_presence_counts_matches_jax():
    tracks = _track_list(1)
    want = jpresence.compute_presence_counts(tracks, GRID)
    got = tpresence.compute_presence_counts(tracks, GRID, device='cpu')
    assert got.dtype == want.dtype == np.int16
    assert got[7, 9] < 0     # wrapped
    np.testing.assert_array_equal(got, want)
    empty = tpresence.compute_presence_counts([], GRID, device='cpu')
    np.testing.assert_array_equal(
        empty, jpresence.compute_presence_counts([], GRID))


def test_smooth_presence_counts_match_jax():
    tracks = _track_list(2)[:-1]
    want = jpresence.compute_smooth_presence_counts(tracks, GRID, 3.)
    got = tpresence.compute_smooth_presence_counts(tracks, GRID, 3.,
                                                   device='cpu')
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    counts = torch.from_numpy(
        tpresence.compute_presence_counts(tracks, GRID, device='cpu')
        .astype(np.int32))
    np.testing.assert_allclose(
        tpresence.smooth_presence_from_counts(counts, 3.).numpy(), want,
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('entry', ['counts', 'smooth'])
def test_presence_entry_points_run_on_the_card_by_default(entry):
    """With no device, ``compute_presence_counts`` and
    ``compute_smooth_presence_counts`` run on the card: without one they
    raise, naming ``device='cpu'``, and with one they give the CPU's
    answer; with ``device='cpu'`` they give ``ssrs_tpu``'s."""
    tracks = _track_list(3)[:-1]
    call, jax_call = {
        'counts': (lambda **kw: tpresence.compute_presence_counts(
            tracks, GRID, **kw),
            lambda: jpresence.compute_presence_counts(tracks, GRID)),
        'smooth': (lambda **kw: tpresence.compute_smooth_presence_counts(
            tracks, GRID, 3., **kw),
            lambda: jpresence.compute_smooth_presence_counts(tracks, GRID,
                                                             3.))}[entry]
    on_cpu = call(device='cpu')
    np.testing.assert_allclose(on_cpu, jax_call(), rtol=1e-5, atol=1e-6)
    if torch.cuda.is_available():
        np.testing.assert_allclose(call(), on_cpu, rtol=1e-5, atol=1e-6)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


def _tracks_of(sim):
    with open(os.path.join(sim.mode_data_dir, f'{ID}_tracks.pkl'),
              'rb') as fobj:
        return pickle.load(fobj)


def test_simulator_default_budget_records_tracks(tmp_path):
    """1000 tracks, the Config default, with the default budget: the run
    writes ``_tracks.pkl`` and ``_counts.npy``, and the recount of the
    one equals the other."""
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path), track_count=1000, **WY), device='cpu')
    assert sim.track_pkl_budget == 10_000
    sim.simulate_tracks()
    tracks = _tracks_of(sim)
    assert isinstance(tracks, list) and len(tracks) == 1000
    for t in tracks:
        assert t.dtype == np.int16 and t.ndim == 2 and t.shape[1] == 2
        assert t.flags.c_contiguous
    counts_path = os.path.join(sim.mode_data_dir, f'{ID}_counts.npy')
    counts = np.load(counts_path)
    assert counts.dtype == np.int32
    rec = {r['phase']: r for r in sim.timer.records}['tracks']
    assert rec['recorded'] and rec['builder'] in ('native', 'python')
    assert rec['useful_steps'] == sum(len(t) for t in tracks) - 1000
    assert 0 < rec['steps'] <= WY['track_max_steps']
    os.remove(counts_path)
    recount = sim.get_presence_counts(sim.case_ids[0], 0)
    assert recount.dtype == np.int16
    np.testing.assert_array_equal(recount.astype(np.int32), counts)


@pytest.fixture(scope='module')
def recorded_sims(tmp_path_factory):
    """The 4096-track WY run with the default budget: once through
    ``ssrs_tpu.Simulator``, once through the port on the JAX package's
    cached potential."""
    root = tmp_path_factory.mktemp('recorded')
    cfg = dict(track_count=4096, **WY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
            out_dir=str(root / 'jax'), **cfg))
        jax_sim.simulate_tracks()
    shared = root / 'port' / WY['run_name'] / 'data' / 'uniform'
    shared.mkdir(parents=True)
    shutil.copy(os.path.join(jax_sim.mode_data_dir, f'{ID}_potential.npy'),
                shared)
    port = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(root / 'port'), **cfg), device='cpu')
    tsim.reset_flush_count()
    port.simulate_tracks()
    return jax_sim, port, tsim.flush_count()


def test_slice_recorded_matches_jax(recorded_sims):
    jax_sim, port, _ = recorded_sims
    tj, tt = _tracks_of(jax_sim), _tracks_of(port)
    assert len(tj) == len(tt) == 4096
    assert all(t.dtype == np.int16 for t in tt)
    cj = np.load(os.path.join(jax_sim.mode_data_dir, f'{ID}_counts.npy'))
    ct = np.load(os.path.join(port.mode_data_dir, f'{ID}_counts.npy'))
    assert ct.dtype == cj.dtype == np.int32 and ct.shape == cj.shape
    assert np.abs(_norm_map(ct) - _norm_map(cj)).sum() < L1_BOUND


def test_slice_recorded_counts_equal_recount(recorded_sims):
    _, port, flushes = recorded_sims
    counts = np.load(os.path.join(port.mode_data_dir, f'{ID}_counts.npy'))
    recount = tpresence.compute_presence_counts(_tracks_of(port),
                                                port.gridsize, device='cpu')
    np.testing.assert_array_equal(recount.astype(np.int32), counts)
    # one flush at the end, and one before each compaction
    assert flushes >= 1
    assert counts.sum() == sum(len(t) for t in _tracks_of(port))
