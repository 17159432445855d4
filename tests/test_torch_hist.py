"""The port's presence histograms (kernels B and C) against the JAX
package's Pallas kernels.

On CPU tensors the wrappers run their plain PyTorch versions; the JAX
kernels run in the Pallas interpreter (the fixture of
``tests/test_pallas_hist.py``). Inputs come from seeded numpy arrays and
the maps must be exactly equal: every weight here sums exactly in
float32, so the order of the sums does not matter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrs_tpu.agents import simulate as jsim
from ssrs_tpu.agents.pallas_hist import (presence_histogram as jhist,
                                         presence_histogram_batch as jbatch)

from ssrs_tpu_torch.agents import simulate as tsim
from ssrs_tpu_torch.agents import presence_hist as ph

GRIDS = [(96, 130), (40, 50), (7, 5)]
SIZES = [0, 700, 5000]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    """Run the Pallas kernels in the interpreter off-TPU."""
    if jax.default_backend() != 'tpu':
        from jax.experimental import pallas as pl
        real_call = pl.pallas_call

        def interp_call(*args, **kwargs):
            kwargs.setdefault('interpret', True)
            return real_call(*args, **kwargs)

        monkeypatch.setattr(pl, 'pallas_call', interp_call)
    yield


def _pad(x):
    return ((x + 127) // 128) * 128


def _indices(rng, n, size):
    """Indices mostly inside [0, size), with some that are negative, equal
    to ``size``, inside the JAX kernels' padding band [size, size_p), and
    beyond it."""
    idx = rng.integers(0, size, n)
    odd = rng.random(n)
    specials = [rng.integers(-40, 0, n), np.full(n, size),
                rng.integers(size, _pad(size), n),
                rng.integers(_pad(size), _pad(size) + 300, n)]
    for k, special in enumerate(specials):
        sel = (odd >= 0.7 + 0.05 * k) & (odd < 0.75 + 0.05 * k)
        idx[sel] = special[sel]
    return idx


def _weights(rng, n, kind):
    if kind == 'zero_one':
        return rng.integers(0, 2, n).astype(np.float32)
    if kind == 'small_int':
        return rng.integers(0, 6, n).astype(np.float32)
    if kind == 'quarters':
        return (rng.integers(0, 21, n) / 4.).astype(np.float32)
    # integers that bf16 rounds (257 -> 256, 259 -> 260, 515 -> 516): the
    # rounding of the weights before the sum must match
    return rng.choice(np.array([0., 257., 259., 515.], np.float32), n)


@pytest.mark.parametrize('kind', ['zero_one', 'small_int', 'quarters',
                                  'bf16_rounded'])
@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('grid', GRIDS)
def test_weighted_histogram_matches_pallas(grid, n, kind):
    nrow, ncol = grid
    rng = np.random.default_rng(1000 * nrow + n + len(kind))
    r = _indices(rng, n, nrow).astype(np.int32)
    c = _indices(rng, n, ncol).astype(np.int32)
    w = _weights(rng, n, kind)
    want = np.asarray(jhist(jnp.asarray(r), jnp.asarray(c), jnp.asarray(w),
                            nrow, ncol))
    got = ph.presence_histogram(torch.from_numpy(r), torch.from_numpy(c),
                                torch.from_numpy(w), nrow, ncol)
    assert got.dtype == torch.int32 and tuple(got.shape) == grid
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype', [np.int16, np.int32])
@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('grid', GRIDS)
def test_count_histogram_matches_pallas(grid, n, dtype):
    nrow, ncol = grid
    rng = np.random.default_rng(7 * nrow + n + np.dtype(dtype).itemsize)
    r = _indices(rng, n, nrow)
    c = _indices(rng, n, ncol)
    # dead points: row -1 with arbitrary columns
    dead = rng.random(n) < 0.3
    r[dead] = -1
    c[dead] = rng.integers(-5, ncol + 5, int(dead.sum()))
    r, c = r.astype(dtype), c.astype(dtype)
    want = np.asarray(jbatch(jnp.asarray(r), jnp.asarray(c), nrow, ncol))
    got = ph.presence_histogram_batch(torch.from_numpy(r),
                                      torch.from_numpy(c), nrow, ncol)
    assert got.dtype == torch.int32 and tuple(got.shape) == grid
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_calls_do_not_count_as_launches():
    ph.reset_launch_count()
    r = torch.tensor([0, 1, 2], dtype=torch.int32)
    ph.presence_histogram(r, r, torch.ones(3), 4, 4)
    ph.presence_histogram_batch(r.to(torch.int16), r.to(torch.int16), 4, 4)
    ph.presence_histogram_batch(r, r, 4, 4, plan=ph._count_plan(4, 4, 10**6))
    ph.presence_flush(r, r, torch.ones(3, dtype=torch.bool),
                      torch.zeros((4, 4), dtype=torch.int32))
    for name in ('presence_flush', 'presence_histogram',
                 'presence_histogram_batch'):
        assert ph.launch_count(name) == 0


@pytest.mark.parametrize('call', [
    lambda: ph.presence_histogram(torch.zeros(3, dtype=torch.int64),
                                  torch.zeros(3, dtype=torch.int32),
                                  torch.ones(3), 4, 4),
    lambda: ph.presence_histogram(torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.int32),
                                  torch.ones(3), 4, 4),
    lambda: ph.presence_histogram_batch(torch.zeros(3, dtype=torch.int16),
                                        torch.zeros(3, dtype=torch.int32),
                                        4, 4),
    lambda: ph.presence_histogram_batch(
        torch.zeros(6, dtype=torch.int32)[::2],
        torch.zeros(3, dtype=torch.int32), 4, 4),
    lambda: ph.presence_flush(torch.zeros(3, dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int32),
                              torch.ones(3), torch.zeros((4, 4),
                                                         dtype=torch.int32)),
    lambda: ph.presence_flush(torch.zeros(3, dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int32),
                              torch.ones(3, dtype=torch.bool),
                              torch.zeros((4, 4), dtype=torch.int64)),
    lambda: ph.presence_flush(torch.zeros(3, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32),
                              torch.ones(3, dtype=torch.bool),
                              torch.zeros((4, 4), dtype=torch.int32)),
])
def test_wrappers_reject_bad_operands(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize('pending', ['random', 'none', 'all', 'alive'])
@pytest.mark.parametrize('grid', [(40, 50), (7, 5)])
def test_flush_matches_jax(grid, pending):
    """One state, given to both packages through ``state_from_numpy``:
    the port's flush (the wrapper, and its plain version on a copy) adds
    exactly what JAX's ``flush_pending`` adds, and clears ``palive``:
    pending flags at random, none, all, and ``palive`` being ``alive``
    itself (as after ``make_step_fn``'s step), which the flush must leave
    as it is."""
    nrow, ncol = grid
    n = 3000
    rng = np.random.default_rng(nrow)
    jp = jsim.TrackParams(grid_shape=grid, move_dirn=0., nu=1., memory_k=1,
                          burnin=2, nsteps=50)
    tp = tsim.TrackParams(grid_shape=grid, move_dirn=0., nu=1., memory_k=1,
                          burnin=2, nsteps=50)
    starts = np.stack([rng.integers(0, nrow, n), rng.integers(0, ncol, n)],
                      axis=1).astype(np.int32)
    js = jsim.init_state(jp, starts, jax.random.key(0),
                         valid=rng.random(n) < 0.6)
    nrow_p, ncol_p = jp.padded_grid
    palive = {'random': js.palive, 'none': jnp.zeros_like(js.palive),
              'all': jnp.ones_like(js.palive),
              'alive': js.alive.astype(js.palive.dtype)}[pending]
    js = js._replace(palive=palive, presence=jnp.asarray(
        rng.integers(0, 50, (nrow_p, ncol_p)).astype(np.int32)))
    ts = tsim.state_from_numpy(
        tp, np.asarray(js.pos_r), np.asarray(js.pos_c), np.asarray(js.mem),
        np.asarray(js.alive), np.asarray(js.palive), np.asarray(js.step),
        np.asarray(js.presence), device='cpu')
    if pending == 'alive':
        ts = dataclasses.replace(ts, palive=ts.alive)
    alive = ts.alive.clone()
    plain_map = ts.presence.clone()
    plain_palive = ph.presence_flush_plain(ts.pos_r, ts.pos_c, ts.palive,
                                           plain_map)
    tsim.reset_flush_count()
    js = jsim.flush_pending(jp, js)
    ts = tsim.flush_pending(ts)
    assert tsim.flush_count() == 1
    want = np.asarray(js.presence)[:nrow, :ncol]
    np.testing.assert_array_equal(ts.presence.numpy(), want)
    np.testing.assert_array_equal(plain_map.numpy(), want)
    assert not ts.palive.any() and not np.asarray(js.palive).any()
    assert not plain_palive.any() and ts.palive.dtype == torch.bool
    assert torch.equal(ts.alive, alive)


def test_flush_counts_only_in_grid_points():
    """Positions outside the grid count nothing (the kernel's bounds
    check; a state never holds one, but the wrapper takes any input)."""
    r = torch.tensor([0, -1, 3, 4, 2, 2], dtype=torch.int32)
    c = torch.tensor([0, 0, 4, 0, -3, 1], dtype=torch.int32)
    presence = torch.zeros((4, 5), dtype=torch.int32)
    cleared = ph.presence_flush(r, c, torch.ones(6, dtype=torch.bool),
                                presence)
    want = torch.zeros((4, 5), dtype=torch.int32)
    want[0, 0] = want[3, 4] = want[2, 1] = 1
    assert torch.equal(presence, want) and not cleared.any()


@pytest.mark.parametrize('grid,bands', [((500, 600), 6), ((700, 700), 10),
                                        ((2000, 2000), 79),
                                        ((6667, 6667), 869)])
def test_count_plan_owns_each_cell_once(grid, bands):
    """The privatized count's plan: the bands cover the grid, a band's
    shared memory is within the card's 227 KB, bands x shares blocks (one
    an SM) fit an H100's 132 SMs where the bands do, and each cell has
    exactly one place: one band, and one index inside the band's shared
    memory (every band of the smaller grids; the first, a middle and the
    last band of the larger)."""
    nrow, ncol = grid
    cells = nrow * ncol
    plan = ph._count_plan(nrow, ncol, 0)
    assert plan.bands == bands
    assert (plan.bands - 1) * plan.band < cells <= plan.bands * plan.band
    assert plan.smem_bytes == 4 * plan.band <= 227 * 1024
    assert plan.shares == max(1, ph.H100_SMS // bands)
    assert plan.bands * plan.shares <= max(ph.H100_SMS, bands)
    seen = (range(bands) if bands <= 10
            else (0, bands // 2, bands - 1))
    for b in seen:
        idx = np.arange(b * plan.band, min((b + 1) * plan.band, cells))
        band, index = ph._cell_owner(plan, idx)
        assert (band == b).all()
        assert index.min() >= 0 and index.max() < plan.band
        assert np.unique(index).size == idx.size


@pytest.mark.parametrize('grid,m,kernel', [
    ((500, 600), 7_525_882, 'privatized'),    # the recorded run's recount
    ((500, 600), 6_400_000, 'privatized'),
    ((500, 600), 3_000_000, 'privatized'),
    ((500, 600), 2_999_999, 'direct'),
    ((500, 600), 10_000, 'direct'),
    ((640, 640), 7_525_882, 'privatized'),    # 8 bands
    ((500, 600), 0, 'direct'),
    ((700, 700), 7_525_882, 'direct'),        # 10 bands
    ((2000, 2000), 7_525_882, 'direct'),
    ((6667, 6667), 10 ** 9, 'direct'),        # BASELINE.json config 5
])
def test_count_plan_picks_kernel(grid, m, kernel):
    assert ph._count_plan(*grid, m).kernel == kernel


def test_count_plan_follows_the_card():
    """The shares fill the card the plan is made for."""
    plan = ph._count_plan(500, 600, 10 ** 7, sms=114)
    assert plan.bands == 6 and plan.shares == 19


@pytest.mark.parametrize('dtype', [np.int16, np.int32, np.int64])
@pytest.mark.parametrize('lengths', [[], [1], [5, 3], [8, 9, 1]])
def test_track_points_layout(lengths, dtype):
    """The recount's planes: the concatenated rows and columns, int16 when
    the tracks are (else int32), each starting 16 bytes apart from the
    other's multiple."""
    from ssrs_tpu_torch.agents.presence import track_points
    rng = np.random.default_rng(len(lengths))
    tracks = [rng.integers(-1, 90, (k, 2)).astype(dtype) for k in lengths]
    rows, cols = track_points(tracks, 'cpu')
    pts = np.concatenate(tracks) if tracks else np.zeros((0, 2))
    want = torch.int16 if dtype == np.int16 or not tracks else torch.int32
    assert rows.dtype == cols.dtype == want
    np.testing.assert_array_equal(rows.numpy(), pts[:, 0])
    np.testing.assert_array_equal(cols.numpy(), pts[:, 1])
    assert rows.is_contiguous() and cols.is_contiguous()
    assert (cols.data_ptr() - rows.data_ptr()) % 16 == 0
