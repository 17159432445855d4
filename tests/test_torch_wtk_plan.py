"""The WTK interpolation plan (``ssrs_tpu_torch/fields/interp.py``)
against SciPy's ``griddata`` as the simulator called it: ``method``, with
the nearest site where it leaves a cell NaN or cannot triangulate.

- A jittered lattice of sites and a grid that reaches past their hull:
  ``linear`` within 1e-12, ``nearest`` and the cells outside the hull bit
  for bit, ``cubic`` (still ``griddata``) bit for bit.
- Sites that cannot be triangulated (two, or on one line): the nearest
  site at every cell, bit for bit.
- A site's NaN: the nearest site's value where the sum is NaN, as before.
- Two components in one application equal two applications.
- ``speed_and_direction`` against NumPy's recomposition.
- Marker ``gpu``: the plan and the recomposition on the card against the
  CPU within 1e-12. This file imports no JAX, so on a machine with the
  card: ``python -m pytest --noconftest -m gpu -q
  tests/test_torch_wtk_plan.py``.
"""

import numpy as np
import pytest
import torch
from scipy.interpolate import griddata
from scipy.spatial import QhullError

from ssrs_tpu_torch.fields.interp import InterpPlan, speed_and_direction

XGRID = np.arange(-2000., 31000., 500.)
YGRID = np.arange(-1500., 24000., 500.)


def _sites(seed=0):
    """A 9x7 lattice of 3-km pitch, each site moved up to 600 m: the grid
    above reaches past its hull on the south and west."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(9) * 3000. + 1000.,
                         np.arange(7) * 3000. + 1000.)
    return np.column_stack([xs.ravel(), ys.ravel()]) + \
        rng.uniform(-600., 600., (xs.size, 2))


def _griddata(points, vals, method):
    """The simulator's interpolation before the plan."""
    mesh = tuple(np.meshgrid(XGRID, YGRID))
    try:
        interp = griddata(points, vals, mesh, method=method)
    except QhullError:
        interp = None
    nearest = griddata(points, vals, mesh, method='nearest')
    if interp is None:
        return nearest
    return np.where(np.isnan(interp), nearest, interp)


def _hull_outside(points):
    mesh = tuple(np.meshgrid(XGRID, YGRID))
    return np.isnan(griddata(points, np.zeros(len(points)), mesh,
                             method='linear'))


def _plan(points, method, device='cpu'):
    return InterpPlan(points, XGRID, YGRID, method, device)


@pytest.mark.parametrize('method', ['linear', 'nearest', 'cubic'])
def test_plan_equals_griddata(method):
    points = _sites()
    outside = _hull_outside(points)
    assert 0.05 < outside.mean() < 0.5
    plan = _plan(points, method)
    rng = np.random.default_rng(1)
    for _ in range(3):
        vals = rng.uniform(-12., 12., len(points))
        got = plan(vals)
        assert got.dtype == torch.float64 and got.shape == (len(YGRID),
                                                            len(XGRID))
        got = got.numpy()
        want = _griddata(points, vals, method)
        if method == 'linear':
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got[outside], _griddata(points, vals, 'nearest')[outside])
    assert (plan.vertices is None) == (method == 'cubic')


@pytest.mark.parametrize('points', [
    np.array([[1000., 1000.], [9000., 5000.]]),
    np.array([[1000., 1000.], [5000., 3000.], [9000., 5000.]]),
    np.array([[1000., 2000.], [5000., 2000.], [9000., 2000.],
              [20000., 2000.]])], ids=['two', 'collinear', 'one_row'])
@pytest.mark.parametrize('method', ['linear', 'cubic'])
def test_plan_without_a_triangulation(points, method):
    vals = np.arange(len(points), dtype=np.float64) * 3. + 3.
    got = _plan(points, method)(vals).numpy()
    np.testing.assert_array_equal(got, _griddata(points, vals, 'nearest'))
    assert set(np.unique(got)) == set(vals)


@pytest.mark.parametrize('method', ['linear', 'nearest', 'cubic'])
def test_plan_takes_the_nearest_site_at_a_nan(method):
    points = _sites(2)
    vals = np.random.default_rng(3).uniform(0., 10., len(points))
    vals[[5, 30]] = np.nan
    got = _plan(points, method)(vals).numpy()
    want = _griddata(points, vals, method)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize('method', ['linear', 'nearest', 'cubic'])
def test_plan_components_together(method):
    points = _sites(4)
    rng = np.random.default_rng(5)
    vals = rng.uniform(-9., 9., (len(points), 2))
    plan = _plan(points, method)
    both = plan(vals)
    assert both.shape == (len(YGRID), len(XGRID), 2)
    for k in range(2):
        np.testing.assert_array_equal(both[..., k].numpy(),
                                      plan(vals[:, k]).numpy())


def test_plan_fits_its_sites_grid_and_method():
    points = _sites()
    plan = _plan(points, 'linear')
    assert plan.fits(points.copy(), XGRID.copy(), YGRID, 'linear')
    moved = points.copy()
    moved[7, 0] += 1e-9
    assert not plan.fits(moved, XGRID, YGRID, 'linear')
    assert not plan.fits(points[:-1], XGRID, YGRID, 'linear')
    assert not plan.fits(points, XGRID + 1., YGRID, 'linear')
    assert not plan.fits(points, XGRID, YGRID[:-1], 'linear')
    assert not plan.fits(points, XGRID, YGRID, 'nearest')


def test_speed_and_direction_equal_numpy():
    rng = np.random.default_rng(6)
    east, north = rng.normal(0., 6., (2, 50_000))
    east[:4], north[:4] = [0., -0., 0., -0.], [0., 0., -3., -3.]
    speed, dirn = speed_and_direction(torch.from_numpy(east),
                                      torch.from_numpy(north))
    want = np.mod(np.arctan2(east, north) + 2 * np.pi, 2 * np.pi)
    np.testing.assert_allclose(speed.numpy(), np.hypot(east, north),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(dirn.numpy(), np.degrees(want), rtol=0,
                               atol=1e-12)
    assert dirn.min() >= 0. and dirn.max() < 360.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('method', ['linear', 'nearest', 'cubic'])
def test_plan_on_the_card_equals_the_cpu(cuda, method):
    points = _sites(7)
    vals = np.random.default_rng(8).uniform(-12., 12., (len(points), 2))
    vals[11, 1] = np.nan
    on_cpu = _plan(points, method)(vals)
    on_card = _plan(points, method, cuda)(vals)
    assert on_card.device.type == 'cuda'
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(),
                               rtol=0, atol=1e-12)
    wind_cpu = speed_and_direction(on_cpu[..., 0], on_cpu[..., 1])
    wind_card = speed_and_direction(on_card[..., 0], on_card[..., 1])
    for got, want in zip(wind_card, wind_cpu):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)
