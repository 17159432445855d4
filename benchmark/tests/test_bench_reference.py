"""The plain reference against the program at small sizes on the CPU:
each piece alike to rounding, the exact expectation of the counts against
sampled walks, the terrain against the program's own raster path."""

import numpy as np
import pytest
import torch

from benchmark import judge, reference as ref, terrain
from conftest import TINY_CONFIG


@pytest.fixture(scope='module')
def field():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(40, 50)).cumsum(0).cumsum(1) * 10 + 1000
    return torch.tensor(z)


def test_fields_match_the_program(field, one_thread):
    from ssrs_tpu_torch.fields import (compute_orographic_updraft,
                                       compute_slope_aspect_degrees,
                                       get_above_threshold_speed)
    s, a = ref.slope_aspect(field, 100.)
    s2, a2 = compute_slope_aspect_degrees(field.float(), 100.)
    assert float((s - s2.double()).abs().max()) < 1e-3
    assert float((a - a2.double()).abs().max()) < 1e-2
    o = ref.orograph(s, a, 10., 270.)
    o2 = compute_orographic_updraft(torch.full(field.shape, 10.),
                                    torch.full(field.shape, 270.), s2, a2)
    t2 = get_above_threshold_speed(o2, 0.75)
    assert float((ref.threshold(o, 0.75) - t2.double()).abs().max()) < 1e-4


def test_moves_match_the_program():
    from ssrs_tpu_torch.agents.moves import (directional_probs,
                                             restriction_table)
    assert (ref.restriction_table() == restriction_table()).all()
    for d in (0., 30., 135., 270.):
        assert np.abs(ref.directional_probs(d)
                      - directional_probs(d)).max() < 1e-7


@pytest.mark.parametrize('dirn', [0., 45., 200., 315.])
def test_boundary_matches_the_program(dirn):
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    m1, v1 = ref.boundary_masks(dirn, (30, 41))
    m2, v2 = boundary_masks(dirn, (30, 41))
    assert (m1 == m2).all() and (v1 == v2).all()


def test_potential_and_table(field, one_thread):
    from ssrs_tpu_torch.agents.moves import directional_probs
    from ssrs_tpu_torch.agents.simulate import prepared_weights
    from ssrs_tpu_torch.potential.direct import (interior_residual,
                                                 solve_potential_direct)
    s, a = ref.slope_aspect(field, 100.)
    cond = ref.threshold(ref.orograph(s, a, 10., 270.), 0.75)
    exact = ref.direct_potential(cond.numpy(), 0.)
    assert ref.interior_residual(torch.tensor(exact), cond, 0.) < 1e-9
    prog = solve_potential_direct(cond.numpy().astype(np.float32), 0.)
    assert np.abs(prog - exact).max() < 1e-2
    assert ref.interior_residual(torch.tensor(prog), cond, 0.) == \
        pytest.approx(interior_residual(prog, cond.numpy(), 0.), rel=1e-6)
    table = ref.move_table(cond, torch.tensor(prog), 0.)
    table2 = prepared_weights(cond.float(), torch.tensor(prog),
                              torch.tensor(directional_probs(0.)),
                              'float32').reshape(table.shape)
    scale = float(table.abs().max())
    assert float((table - table2.double()).abs().max()) < 1e-6 * scale


def test_expectation_against_walks(field):
    """The exact expectation sits inside the spread of sampled walks of
    the same chain, which two walks with other seeds show."""
    s, a = ref.slope_aspect(field, 100.)
    cond = ref.threshold(ref.orograph(s, a, 10., 270.), 0.75)
    pot = torch.tensor(ref.direct_potential(cond.numpy(), 0.))
    table = ref.move_table(cond, pot, 0.)
    rng = np.random.default_rng(1)
    rows = rng.integers(1, 3, 20000)
    cols = rng.integers(1, 49, 20000)
    hist = ref.start_histogram(rows, cols, field.shape, 'cpu')
    want = ref.expected_counts(ref.transitions(table, 0., 1, 1.),
                               hist[None], 4, 200)[0]
    starts = torch.tensor(np.stack([rows, cols], 1))
    walks = [ref.walk_counts(table[None], starts, 0., 1, 1., 4, 200,
                             torch.Generator().manual_seed(k))[0]
             for k in (1, 2)]
    assert float(walks[0].sum()) == pytest.approx(float(want.sum()),
                                                  rel=0.02)
    noise = judge.block_l1(walks[0], walks[1], 5)
    for w in walks:
        assert judge.block_l1(w, want, 5) < noise


def test_terrain_is_the_programs(tmp_path):
    """The benchmark's raster is read by the program as written, and the
    reference's resampling of it equals the program's."""
    from ssrs_tpu_torch.data.geotiff import read_geotiff
    from ssrs_tpu_torch.data.raster import get_raster_in_projected_crs
    from ssrs_tpu_torch.data.synthetic import synthetic_dem_lonlat
    cfg = dict(TINY_CONFIG, projected_crs='ESRI:102008',
               southwest_lonlat=(-106.21, 42.78))
    dem, bnds = terrain.make_dem(cfg)
    assert np.array_equal(dem, synthetic_dem_lonlat(bnds)[0])
    path = str(tmp_path / 'srtm1.tif')
    terrain.write_dem_tiff(path, dem, bnds)
    info = read_geotiff(path)
    assert info.crs_code == 'EPSG:4326'
    assert np.allclose(info.bounds, bnds, rtol=0, atol=1e-12)
    assert np.array_equal(info.data, dem.astype(np.float64))
    shape, bounds, _ = terrain.region(cfg)
    prog = get_raster_in_projected_crs(path, bounds, shape, 200.,
                                       'ESRI:102008')
    assert np.abs(prog - terrain.reproject(dem, bnds, cfg)).max() < 1e-9
