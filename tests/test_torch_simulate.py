"""The port's agent engine against the JAX package's.

- Steps, flush and compaction: both engines start from the same state
  (``state_from_numpy``) and table, take the same injected uniforms, and
  must agree exactly (nu = 1: the same float32 operations in the same
  order; presence counts are integers).
- ``simulate_presence_compacting``: the two packages draw from
  different generators (threefry and Philox never agree), so their
  smoothed, normalized
  presence maps are compared with the L1 bound of
  ``tests/test_compaction.py``; the port is deterministic for a fixed
  seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrs_tpu.agents import simulate as jsim
from ssrs_tpu.agents.moves import directional_probs, restriction_table
from ssrs_tpu.agents.presence import smooth_presence as jsmooth

from ssrs_tpu_torch.agents import simulate as tsim
from ssrs_tpu_torch.agents.presence import smooth_presence as tsmooth

GRID = (48, 56)
N = 2048
BUCKET = 1024


def _fields():
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    return updraft, potential


def _jax_table(dtype, dirn=0.):
    up, pot = _fields()
    return jsim.prepared_weights(jnp.asarray(up), jnp.asarray(pot),
                                 jnp.asarray(directional_probs(dirn)), dtype)


def _to_port(params, state):
    return tsim.state_from_numpy(
        params, np.asarray(state.pos_r), np.asarray(state.pos_c),
        np.asarray(state.mem), np.asarray(state.alive),
        np.asarray(state.palive), np.asarray(state.step),
        np.asarray(state.presence), device='cpu')


def _assert_same(params, js, ts):
    nrow, ncol = params.grid_shape
    np.testing.assert_array_equal(ts.pos_r.numpy(), np.asarray(js.pos_r))
    np.testing.assert_array_equal(ts.pos_c.numpy(), np.asarray(js.pos_c))
    np.testing.assert_array_equal(ts.mem.numpy(), np.asarray(js.mem))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ts.palive.numpy(),
                                  np.asarray(js.palive) != 0)
    np.testing.assert_array_equal(
        ts.presence.numpy(), np.asarray(js.presence)[:nrow, :ncol])
    assert ts.step == int(js.step)


@pytest.mark.parametrize('k,dtype', [(0, 'float32'), (1, 'float32'),
                                     (3, 'float32'), (1, 'bfloat16')])
def test_steps_flush_compaction_exact(k, dtype):
    """12 steps (through the burn-in push and boundary deaths), flush,
    compaction to a bucket, 12 more steps, flush: exactly equal."""
    rng = np.random.default_rng(100 + k)
    nrow, ncol = GRID
    jp = jsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=k,
                          burnin=4, nsteps=150, weight_dtype=dtype,
                          step_impl='fused-interpret')
    tp = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=k,
                          burnin=4, nsteps=150, weight_dtype=dtype)
    table = _jax_table(dtype)
    dirp = directional_probs(0.)
    jstep = jsim.make_step_fn(jp, table, jnp.asarray(dirp),
                              jnp.asarray(restriction_table()))
    tstep = tsim.make_step_fn(tp, tsim.weights_from_numpy(
        np.asarray(table), 'cpu'), torch.from_numpy(dirp),
        torch.from_numpy(restriction_table()))
    starts = np.stack([rng.integers(0, nrow, N), rng.integers(0, ncol, N)],
                      axis=1).astype(np.int32)
    valid = rng.random(N) < 0.45    # the survivors fit the bucket
    js = jsim.init_state(jp, starts, jax.random.key(0), valid=valid)
    ts = _to_port(tp, js)
    _assert_same(tp, js, ts)
    for phase in range(2):
        n = js.pos_r.shape[0]
        for _ in range(12):
            u = rng.random(n).astype(np.float32)
            js = jstep(js, u=jnp.asarray(u))
            ts = tstep(ts, u=torch.from_numpy(u))
        js = jsim.flush_pending(jp, js)
        ts = tsim.flush_pending(ts)
        _assert_same(tp, js, ts)
        if phase == 0:
            assert int(np.asarray(js.alive).sum()) <= BUCKET
            js = jsim._compact(jp, js, BUCKET)
            ts, _ = tsim._compact_body(ts, BUCKET)
            _assert_same(tp, js, ts)


@pytest.mark.parametrize('n_alive,min_bucket', [
    (1, 1024), (1000, 256), (1537, 256), (3000, 1024), (70000, 1024)])
def test_bucket_ladder_matches(n_alive, min_bucket):
    assert tsim._bucket_for(n_alive, min_bucket) == \
        jsim._bucket_for(n_alive, min_bucket)


def test_tail_bucket_knob():
    """The JAX package's normalization: ``'auto'`` starts as the
    ``min_bucket`` switch."""
    for tb in (0, -5, 4096, 'auto', 100):
        assert tsim._norm_tail_bucket(tb, 1024) == \
            jsim._norm_tail_bucket(tb, 1024)
    assert tsim._norm_tail_bucket('auto', 1024) == 1024
    assert tsim._norm_tail_bucket(-5, 1024) == -1
    assert tsim._norm_tail_bucket(4096, 1024) == 4096
    with pytest.raises(ValueError):
        tsim._norm_tail_bucket(1.5, 1024)


def _norm_smooth(p, smooth):
    a = np.asarray(smooth(p, 3), np.float64)
    return a / a.sum()


def _starts(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(3, 6, n), rng.integers(20, 36, n)],
                    axis=1).astype(np.int32)


def test_compacting_matches_jax_statistically():
    n = 4096
    starts = _starts(n, 8)
    table = _jax_table('bfloat16')
    jp = jsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                          burnin=4, nsteps=300, weight_dtype='bfloat16')
    tp = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                          burnin=4, nsteps=300, weight_dtype='bfloat16')
    pj, sj = jsim.simulate_presence_compacting(
        jp, starts, jax.random.key(5), base_flat=table, chunk=64,
        min_bucket=256)
    gen = torch.Generator().manual_seed(5)
    pt, st = tsim.simulate_presence_compacting(
        tp, starts, gen, base_flat=tsim.weights_from_numpy(
            np.asarray(table), 'cpu'), chunk=64, min_bucket=256)
    assert pt.shape == GRID and pt.dtype == torch.int32
    assert 0 < st <= 300 and int(sj) <= 300
    a = _norm_smooth(np.asarray(pj), jsmooth)
    b = _norm_smooth(pt, tsmooth)
    assert np.abs(a - b).sum() < 0.08
    # every agent contributes at least its burn-in + 1 presence points
    assert int(pt.sum()) >= n * (tp.burnin + 1)


def test_compacting_deterministic():
    """A fixed seed gives the same map and step count; every agent
    counts at least its burn-in steps and its start."""
    up, pot = _fields()
    tp = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                          burnin=4, nsteps=200)
    starts = _starts(1500, 9)
    runs = [tsim.simulate_presence_compacting(
        tp, starts, torch.Generator().manual_seed(11), updraft=up,
        potential=pot, chunk=32, min_bucket=128) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert int(runs[0][0].sum()) >= 1500 * (tp.burnin + 1)


# ---- tail_bucket='auto' ----------------------------------------------------


def _spy_compactions(monkeypatch):
    """Record the bucket of every compaction the drivers make."""
    buckets = []
    real = tsim._compact_body

    def spy(state, m):
        buckets.append(m)
        return real(state, m)

    monkeypatch.setattr(tsim, '_compact_body', spy)
    return buckets


def _auto_rule(monkeypatch, rtt, key=None, per_slot=None):
    """``tail_bucket='auto'`` with a round trip of ``rtt`` seconds and, for
    ``key``, a per-slot estimate already made."""
    monkeypatch.setattr(tsim, '_dispatch_overhead', lambda device: rtt)
    monkeypatch.setattr(tsim, '_PER_SLOT',
                        {} if key is None else {key: per_slot})


def _auto_case():
    up, pot = _fields()
    tp = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                          burnin=4, nsteps=300)
    kw = dict(updraft=up, potential=pot, chunk=16, min_bucket=64)
    # starts over every row, so that the agents reach the far edge over
    # many chunks and the driver compacts several times
    rng = np.random.default_rng(3)
    starts = np.stack([rng.integers(2, GRID[0] - 2, 2048),
                       rng.integers(2, GRID[1] - 2, 2048)],
                      axis=1).astype(np.int32)
    return tp, starts, kw


def _run(tp, starts, kw, tail):
    return tsim.simulate_presence_compacting(
        tp, starts, torch.Generator().manual_seed(4), tail_bucket=tail, **kw)


def test_auto_tail_without_round_trip_is_tail_zero(monkeypatch):
    """A round trip of 0 s never pays for stopping: 'auto' compacts as
    tail_bucket=0 does, bit for bit, and estimates a per-slot cost."""
    tp, starts, kw = _auto_case()
    buckets = _spy_compactions(monkeypatch)
    want = _run(tp, starts, kw, 0)
    assert len(buckets) >= 2
    _auto_rule(monkeypatch, 0.)
    got = _run(tp, starts, kw, 'auto')
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert buckets[:len(buckets) // 2] == buckets[len(buckets) // 2:]
    assert tsim._PER_SLOT[(tp, 16, 'cpu')] > 0


def test_auto_tail_with_long_round_trip_stops_at_first_bucket(monkeypatch):
    """A round trip longer than every chunk, with a per-slot cost already
    estimated: compaction stops at the first bucket it packs, so the run
    is the run whose tail_bucket is that bucket, bit for bit."""
    tp, starts, kw = _auto_case()
    buckets = _spy_compactions(monkeypatch)
    _run(tp, starts, kw, 0)
    first = buckets[0]
    del buckets[:]
    _auto_rule(monkeypatch, 1e9, (tp, 16, 'cpu'), 1e-12)
    got = _run(tp, starts, kw, 'auto')
    assert buckets == [first]
    want = _run(tp, starts, kw, first)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    # a chunk wall under the round trip says nothing: the estimate stays
    assert tsim._PER_SLOT[(tp, 16, 'cpu')] == 1e-12


def test_dispatch_overhead_is_measured_once(monkeypatch):
    monkeypatch.setattr(tsim, '_DISPATCH_OVERHEAD', {})
    rtt = tsim._dispatch_overhead('cpu')
    assert 0 < rtt < 1
    assert tsim._dispatch_overhead(torch.device('cpu')) == rtt
    assert list(tsim._DISPATCH_OVERHEAD) == ['cpu']
