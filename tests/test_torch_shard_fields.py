"""The port's row-sharded fields (``ssrs_tpu_torch/parallel/fields.py``)
on the CPU, over meshes that repeat the CPU device.

- The weight planes, the crossing planes, the inverse diagonals and
  ``potential/lap.py``'s smoother given row blocks: bit-identical to the
  single-device ones (the stencils are local, the halos exact copies).
- The orograph over row blocks: bitwise the single-device one, and within
  the fields' float32 tolerance (rtol 1e-5 + atol 1e-4) of the JAX
  package's ``orographic_updraft_from_dem_sharded``
  (``tests/test_shard_fields.py``'s DEM and call).
- The refined solve on the 256x224 hard field of
  ``tests/test_shard_fields.py``: rrel < 1e-5, within 0.05 of the
  single-device port solve and of the JAX package's sharded solve (the
  bound of ``tests/test_shard_fields.py``); two sharded solves bitwise
  equal; the transfer counter shows no full-field block moving between
  shards, only halo rows, per-island partials and the gathered coarse
  levels (the counterpart of that file's HLO bound).
"""

import jax  # noqa: F401  (the conftest's 8 virtual devices)
import numpy as np
import pytest
import torch

from ssrs_tpu.parallel.fields import \
    orographic_updraft_from_dem_sharded as jax_oro_sharded
from ssrs_tpu.parallel.fields import \
    solve_potential_refined_sharded as jax_solve_sharded
from ssrs_tpu_torch.fields.updraft import orographic_updraft_from_dem
from ssrs_tpu_torch.parallel import fields as pf
from ssrs_tpu_torch.potential import lap
from ssrs_tpu_torch.potential.boundary import boundary_masks
from ssrs_tpu_torch.potential.fields import conductivity_hard

from test_potential import _conductivity_hard

SHAPE = (256, 224)
CPU4 = ['cpu'] * 4


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """Torch on one thread, as in tests/test_torch_potential.py: a solve's
    many small ops crawl beside other test workers otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(shape=SHAPE):
    cond = conductivity_hard(shape, seed=1)
    bmask, bvals = boundary_masks(0., shape)
    return cond, np.asarray(bmask), np.asarray(bvals)


def test_hard_field_is_the_jax_tests():
    np.testing.assert_array_equal(conductivity_hard(SHAPE, seed=1),
                                  _conductivity_hard(SHAPE, seed=1))


@pytest.mark.parametrize('shape, n, offsets, last', [
    ((256, 224), 4, [0, 64, 128, 192, 256], 3),
    ((500, 600), 4, [0, 128, 256, 384, 500], 3),
    ((460, 460), 4, [0, 128, 256, 384, 460], 3),
    ((50, 60), 4, [0, 14, 28, 42, 50], 0),
])
def test_plan_rows(shape, n, offsets, last):
    """Every block but the last holds a multiple of 2^(last+1) rows, and
    the blocks of level ``last`` keep at least 8 rows."""
    got, got_last = pf.plan_rows(shape, n)
    assert (got, got_last) == (offsets, last)
    assert all(o % 2 ** (last + 1) == 0 for o in got[:-1])


def test_plan_rows_refuses_too_few_rows():
    with pytest.raises(ValueError, match='shard'):
        pf.plan_rows((9, 40), 4)
    with pytest.raises(ValueError, match='one multigrid level'):
        pf.plan_rows((4, 40), 2)


def test_sharded_levels_and_smoother_bit_identical():
    cond, bmask, _ = _setup()
    labels, k = lap.island_labels(cond > 0, bmask)
    num = k + 1
    planes = lap.symmetrize_planes(lap.weight_planes(torch.from_numpy(cond)))
    levels = lap.build_lap_levels(planes, torch.from_numpy(bmask), labels,
                                  num)
    offsets, last = pf.plan_rows(SHAPE, 4)
    moves = pf.Transfers()
    cond_s = pf.RowBlocks.split(cond, offsets, CPU4, moves)
    planes_s = cond_s.stencil(lap.weight_planes).stencil(
        lap.symmetrize_planes)
    assert torch.equal(planes_s.gather(), planes)
    got_levels = pf.build_shard_levels(
        planes_s, pf.RowBlocks.split(bmask, offsets, CPU4, moves), bmask,
        labels, num, last)
    assert len(got_levels) == len(levels)
    shard = got_levels[:last + 1]
    assert all(isinstance(lv.planes, pf.RowBlocks) for lv in shard)
    for got, want in zip(shard, levels):
        for name in ('planes', 'planes_x', 'notb', 'dinv'):
            assert torch.equal(getattr(got, name).gather(),
                               getattr(want, name))
        # the island sums' partials add in another order
        np.testing.assert_allclose(got.zaz_inv.numpy(),
                                   want.zaz_inv.numpy(), rtol=1e-12)
    for got, want in zip(got_levels[last + 1:], levels[last + 1:]):
        assert torch.equal(got.planes, want.planes)
    rng = np.random.default_rng(0)
    u = (rng.random(SHAPE) - 0.5).astype(np.float32)
    rhs = (rng.random(SHAPE) - 0.5).astype(np.float32)
    want = lap._smooth(levels[0], torch.from_numpy(u), torch.from_numpy(rhs),
                       3)
    moves = pf.Transfers()
    # lap's own smoother, given row blocks
    got = lap._smooth(shard[0], pf.RowBlocks.split(u, offsets, CPU4, moves),
                      pf.RowBlocks.split(rhs, offsets, CPU4, moves), 3)
    # three sweeps: one halo row each way between each pair of neighbours
    assert moves.summary() == {'halo': {
        'moves': 3 * 2 * 3, 'bytes': 3 * 2 * 3 * SHAPE[1] * 4,
        'largest': SHAPE[1] * 4}}
    assert torch.equal(got.gather(), want)


@pytest.mark.parametrize('shape, n', [((256, 224), 4), ((100, 90), 3)])
def test_sharded_vcycle_matches_single_device(shape, n):
    """``lap.vcycle`` over sharded levels, the gather onto mesh[0] and the
    split back included, is the single-device V-cycle on a field with no
    floating island (no sum is taken inside the cycle then), up to the
    inverse diagonals: ``torch.sum`` over the eight planes may round a
    block of another shape apart by an ulp."""
    rng = np.random.default_rng(5)
    cond = (0.5 + rng.random(shape)).astype(np.float32)
    bmask = np.asarray(boundary_masks(0., shape)[0])
    labels, k = lap.island_labels(cond > 0, bmask)
    assert k == 0
    planes = lap.symmetrize_planes(lap.weight_planes(torch.from_numpy(cond)))
    levels = lap.build_lap_levels(planes, torch.from_numpy(bmask), labels, 1)
    offsets, last = pf.plan_rows(shape, n)
    mesh, moves = ['cpu'] * n, pf.Transfers()
    shard = pf.build_shard_levels(
        pf.RowBlocks.split(planes, offsets, mesh, moves),
        pf.RowBlocks.split(bmask, offsets, mesh, moves), bmask, labels, 1,
        last)
    rhs = (rng.random(shape) - 0.5).astype(np.float32)
    want = lap.vcycle(levels, torch.from_numpy(rhs), torch.zeros(shape))
    rhs_s = pf.RowBlocks.split(rhs, offsets, mesh, moves)
    got = lap.vcycle(shard, rhs_s, rhs_s.map(torch.zeros_like))
    torch.testing.assert_close(got.gather(), want, rtol=1e-5, atol=1e-6)
    summary = moves.summary()
    assert summary['gather']['moves'] >= n - 1
    assert summary['split']['moves'] == n - 1


def test_row_blocks_arithmetic():
    """Operators block by block; a scalar tensor is copied to each shard;
    a field-sized tensor is refused."""
    moves = pf.Transfers()
    x = torch.arange(12.).reshape(4, 3)
    xs = pf.RowBlocks.split(x, [0, 2, 4], ['cpu'] * 2, moves)
    two = torch.tensor(2.)
    got = (1. - xs * two + xs) * xs - (-xs)
    assert torch.equal(got.gather(), (1. - x * two + x) * x - (-x))
    assert torch.equal((two * xs).gather(), two * x)
    assert float(xs.total()) == float(x.sum())
    assert float(xs.norm()) == pytest.approx(float(x.norm()), rel=1e-6)
    lab = pf.RowBlocks.split(torch.tensor([[0, 1, 2]] * 4), [0, 2, 4],
                             ['cpu'] * 2, moves)
    assert torch.equal(lab.spread(torch.tensor([5., 6., 7.])).gather(),
                       torch.tensor([[5., 6., 7.]] * 4))
    with pytest.raises(ValueError, match='0-d'):
        xs * x


@pytest.mark.parametrize('n', [2, 3, 4, 8])
def test_sharded_orograph(synthetic_dem, n):
    z = synthetic_dem[:112, :144].astype(np.float32)  # rows % 8 == 0
    want = orographic_updraft_from_dem(
        torch.from_numpy(z), 30., torch.tensor(10.), torch.tensor(270.))
    got = pf.orographic_updraft_from_dem_sharded(z, 30., 10., 270.,
                                                 mesh=['cpu'] * n)
    assert len(got.blocks) == n
    assert torch.equal(got.gather(), want)
    if n == 8:
        ref = np.asarray(jax_oro_sharded(z, 30., 10., 270.))
        np.testing.assert_allclose(got.gather().numpy(), ref, rtol=1e-5,
                                   atol=1e-4)


@pytest.fixture(scope='module')
def solves():
    cond, bmask, bvals = _setup()
    single, rrel_1 = lap.solve_potential_refined(cond, bmask, bvals,
                                                 device='cpu')
    stats = {}
    sharded, rrel_4 = pf.solve_potential_refined_sharded(
        cond, bmask, bvals, mesh=CPU4, stats=stats)
    again, rrel_again = pf.solve_potential_refined_sharded(
        torch.from_numpy(cond), bmask, bvals, mesh=CPU4)
    jax_pot, jax_rrel = jax_solve_sharded(cond, bmask, bvals)
    return dict(single=single.numpy(), rrel_1=rrel_1, sharded=sharded,
                rrel_4=rrel_4, stats=stats, again=again,
                rrel_again=rrel_again, jax=np.asarray(jax_pot),
                jax_rrel=float(jax_rrel), bvals=bvals, bmask=bmask)


def test_sharded_solve_hard_field(solves):
    got = solves['sharded'].gather().numpy()
    assert solves['rrel_4'] < 1e-5 and solves['jax_rrel'] < 1e-5
    assert got.dtype == np.float32 and got.shape == SHAPE
    np.testing.assert_array_equal(got[solves['bmask']],
                                  solves['bvals'][solves['bmask']])
    assert np.abs(got - solves['single']).max() < 0.05
    assert np.abs(got - solves['jax']).max() < 0.05
    assert solves['stats']['shards'] == 4
    assert solves['stats']['sharded_levels'] == 4
    assert solves['stats']['vcycles'] > 0


def test_sharded_solve_bitwise_repeatable(solves):
    """A second solve on the same mesh, from a tensor this time, gives the
    same bits: every partial sum adds in block order."""
    assert torch.equal(solves['again'].gather(), solves['sharded'].gather())
    assert solves['rrel_again'] == solves['rrel_4']


def test_sharded_solve_moves_no_full_field(solves):
    """Between shards move only halo rows, partials and scalars, and the
    coarse levels gathered onto mesh[0] (level 4 here: 16x14 cells): no
    move carries as much as a block of the fine field."""
    summary = solves['stats']['transfers']
    assert set(summary) == {'halo', 'reduce', 'bcast', 'gather', 'split'}
    cells = SHAPE[0] * SHAPE[1]
    coarse_cells = (SHAPE[0] // 16) * (SHAPE[1] // 16)
    # a halo row of the eight weight planes
    assert summary['halo']['largest'] == 8 * SHAPE[1] * 4
    # the gathered level's weight planes, at most
    assert summary['gather']['largest'] <= 8 * coarse_cells * 4
    assert summary['split']['largest'] <= coarse_cells * 4
    for rec in summary.values():
        assert rec['largest'] < cells * 4 // 16
    # an input on mesh[0] is cut into blocks: the only block-sized moves
    moves = pf.Transfers()
    pf.RowBlocks.split(torch.zeros(SHAPE), pf.plan_rows(SHAPE, 4)[0], CPU4,
                       moves)
    assert moves.summary() == {'scatter': {
        'moves': 3, 'bytes': 3 * 64 * SHAPE[1] * 4,
        'largest': 64 * SHAPE[1] * 4}}


def test_sharded_solve_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    cond, bmask, bvals = _setup((64, 64))
    with pytest.raises(RuntimeError, match='CUDA'):
        pf.solve_potential_refined_sharded(cond, bmask, bvals)
    with pytest.raises(RuntimeError, match='CUDA'):
        pf.orographic_updraft_from_dem_sharded(cond, 30., 10., 270.)
