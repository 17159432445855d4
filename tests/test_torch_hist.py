"""The port's presence histograms (kernels B and C) against the JAX
package's Pallas kernels.

On CPU tensors the wrappers run their plain PyTorch versions; the JAX
kernels run in the Pallas interpreter (the fixture of
``tests/test_pallas_hist.py``). Inputs come from seeded numpy arrays and
the maps must be exactly equal: every weight here sums exactly in
float32, so the order of the sums does not matter.
"""

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
    assert ph.launch_count('presence_histogram') == 0
    assert ph.launch_count('presence_histogram_batch') == 0


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
])
def test_wrappers_reject_bad_operands(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize('grid', [(40, 50), (7, 5)])
def test_flush_matches_jax(grid):
    """One state, given to both packages through ``state_from_numpy``:
    the port's flush (kernel B's plain version) adds exactly what JAX's
    ``flush_pending`` adds, and clears ``palive``."""
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
    js = js._replace(presence=jnp.asarray(
        rng.integers(0, 50, (nrow_p, ncol_p)).astype(np.int32)))
    ts = tsim.state_from_numpy(
        tp, np.asarray(js.pos_r), np.asarray(js.pos_c), np.asarray(js.mem),
        np.asarray(js.alive), np.asarray(js.palive), np.asarray(js.step),
        np.asarray(js.presence), device='cpu')
    tsim.reset_flush_count()
    js = jsim.flush_pending(jp, js)
    ts = tsim.flush_pending(ts)
    assert tsim.flush_count() == 1
    np.testing.assert_array_equal(ts.presence.numpy(),
                                  np.asarray(js.presence)[:nrow, :ncol])
    assert not ts.palive.any() and not np.asarray(js.palive).any()
