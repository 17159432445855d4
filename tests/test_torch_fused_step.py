"""The port's fused agent step against the JAX package's Pallas kernel.

``ssrs_tpu_torch.agents.fused_step_plain`` (the plain PyTorch version of
the CUDA kernel, which the wrapper runs on CPU tensors) is held against
``ssrs_tpu.agents.fused_step.fused_step_call`` in interpret mode on the
same numpy inputs: exactly at nu in {0, 1}, where both take the same
float32 operations in the same order, and at >= 99.9% equal moves at
nu in {0.5, 2}, where exp/log round differently between XLA and torch.
Tests of the CUDA kernel itself need the card (marker ``gpu``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrs_tpu.agents.fused_step import fused_step_call
from ssrs_tpu.agents.moves import directional_probs, restriction_table
import ssrs_tpu_torch.agents.fused_step as fs
from ssrs_tpu_torch.agents.simulate import weights_from_numpy

GRID = (48, 56)
N = 2048          # a multiple of the JAX kernel's 1024-agent block
N_RAGGED = 2000   # the port needs no padding


def _inputs(seed, n, k, dtype):
    """A table with all-zero and sparse rows, and a state with dead
    agents, agents with palive 0, and random memory (so some masks zero
    every allowed move): every branch of the cascade runs."""
    rng = np.random.default_rng(seed)
    nrow, ncol = GRID
    table = (rng.random((nrow * ncol, 9)) * 50.).astype(np.float32)
    kind = rng.random(nrow * ncol)
    table[kind < 0.2] = 0.
    sparse = (kind >= 0.2) & (kind < 0.5)
    table[sparse] *= rng.random((int(sparse.sum()), 9)) < 0.2
    table[:, 4] = 0.
    table = np.asarray(jnp.asarray(table).astype(jnp.dtype(dtype)))
    return dict(
        table=table,
        pr=rng.integers(1, nrow - 1, n).astype(np.int32),
        pc=rng.integers(1, ncol - 1, n).astype(np.int32),
        r=rng.integers(0, nrow, n).astype(np.int32),
        c=rng.integers(0, ncol, n).astype(np.int32),
        alive=rng.random(n) < 0.85,
        palive=rng.random(n) < 0.85,
        mem=rng.integers(0, 9, (max(k, 1), n)).astype(np.int32),
        u=rng.random(n).astype(np.float32))


def _jax_step(a, k, nu):
    """The Pallas kernel in interpret mode, with the table gathered as
    ``simulate._make_fused_step`` gathers it."""
    ncol = GRID[1]
    base = jnp.asarray(a['table'])[a['pr'] * ncol + a['pc']].T
    out = fused_step_call(
        jnp.asarray(restriction_table()).T,
        jnp.asarray(directional_probs(0.))[:, None], base,
        jnp.asarray(a['pr']), jnp.asarray(a['pc']), jnp.asarray(a['r']),
        jnp.asarray(a['c']), jnp.asarray(a['alive'].astype(np.int32)),
        jnp.asarray(a['palive'].astype(np.int32)), jnp.asarray(a['mem']),
        jnp.asarray(a['u']), nu=nu, memory_k=k, grid_shape=GRID,
        hist_mode='lanes', hist_src='cur', interpret=True)
    nr, nc, nm, hist = (np.asarray(x) for x in out)
    return nr, nc, nm, hist[:GRID[0], :GRID[1]]


def _torch_step(a, k, nu):
    t = {key: torch.from_numpy(np.ascontiguousarray(v))
         for key, v in a.items() if key != 'table'}
    presence = torch.zeros(GRID, dtype=torch.int32)
    nr, nc, nm = fs.fused_step_plain(
        weights_from_numpy(a['table'], 'cpu'),
        torch.from_numpy(restriction_table()),
        torch.from_numpy(directional_probs(0.)), t['pr'], t['pc'], t['r'],
        t['c'], t['alive'], t['palive'], t['mem'], t['u'], presence,
        nu=nu, memory_k=k)
    return nr.numpy(), nc.numpy(), nm.numpy(), presence.numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('k', [0, 1, 3])
@pytest.mark.parametrize('nu', [1.0, 0.0])
def test_plain_step_exact_vs_pallas(k, nu, dtype):
    a = _inputs(10 * k + int(nu), N, k, dtype)
    for got, want in zip(_torch_step(a, k, nu), _jax_step(a, k, nu)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('nu', [0.5, 2.0])
def test_plain_step_sharpened_vs_pallas(nu):
    """exp/log differ by ulps between XLA and torch: >= 99.9% of moves
    equal, presence (independent of nu) exact."""
    a = _inputs(7, N, 1, 'float32')
    nr, nc, _, pres = _torch_step(a, 1, nu)
    jr, jc, _, jpres = _jax_step(a, 1, nu)
    assert np.mean((nr == jr) & (nc == jc)) >= 0.999
    np.testing.assert_array_equal(pres, jpres)


@pytest.mark.parametrize('k', [0, 1, 3])
def test_plain_step_ragged_population(k):
    """N = 2000 on the port against the JAX kernel at 2048 with 48
    padding agents that are dead and count nothing."""
    a = _inputs(3 + k, N, k, 'bfloat16')
    a['alive'][N_RAGGED:] = False
    a['palive'][N_RAGGED:] = False
    jr, jc, jm, jpres = _jax_step(a, k, 1.0)
    cut = {key: (v if key == 'table' else v[..., :N_RAGGED])
           for key, v in a.items()}
    nr, nc, nm, pres = _torch_step(cut, k, 1.0)
    np.testing.assert_array_equal(nr, jr[:N_RAGGED])
    np.testing.assert_array_equal(nc, jc[:N_RAGGED])
    np.testing.assert_array_equal(nm, jm[:, :N_RAGGED])
    np.testing.assert_array_equal(pres, jpres)


def test_wrapper_uses_plain_on_cpu_and_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version, and the launch
    counter stays 0."""
    fs.reset_launch_count()
    a = _inputs(5, N_RAGGED, 1, 'float32')
    t = {key: torch.from_numpy(np.ascontiguousarray(v))
         for key, v in a.items() if key != 'table'}
    args = (weights_from_numpy(a['table'], 'cpu'),
            torch.from_numpy(restriction_table()),
            torch.from_numpy(directional_probs(0.)), t['pr'], t['pc'],
            t['r'], t['c'], t['alive'], t['palive'], t['mem'], t['u'])
    p1, p2 = torch.zeros(GRID, dtype=torch.int32), \
        torch.zeros(GRID, dtype=torch.int32)
    out1 = fs.fused_step(*args, p1, nu=1.0, memory_k=1)
    out2 = fs.fused_step_plain(*args, p2, nu=1.0, memory_k=1)
    for x, y in zip(out1 + (p1,), out2 + (p2,)):
        assert torch.equal(x, y)
    assert fs.launch_count() == 0


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'contiguity', 'table'])
def test_wrapper_rejects_bad_operands(bad):
    a = _inputs(6, 64, 1, 'float32')
    t = {key: torch.from_numpy(np.ascontiguousarray(v))
         for key, v in a.items() if key != 'table'}
    table = weights_from_numpy(a['table'], 'cpu')
    if bad == 'dtype':
        t['pr'] = t['pr'].long()
    elif bad == 'shape':
        t['u'] = t['u'][:-1]
    elif bad == 'contiguity':
        t['pr'] = torch.ones(128, dtype=torch.int32)[::2]
    else:
        table = table[:-1]
    with pytest.raises(ValueError):
        fs.fused_step(table, torch.from_numpy(restriction_table()),
                      torch.from_numpy(directional_probs(0.)), t['pr'],
                      t['pc'], t['r'], t['c'], t['alive'], t['palive'],
                      t['mem'], t['u'], torch.zeros(GRID, dtype=torch.int32),
                      nu=1.0, memory_k=1)
