"""The port's host copies, fields, weight table and direct potential
against the JAX package, on the same numpy inputs.

- Host copies (grid, move tables, starts, boundary nodes, CRS, GeoTIFF,
  the synthetic DEM): exact.
- Fields: ``rtol=1e-5, atol=1e-4``; XLA and torch compute the same
  float32 formulas, but their transcendentals (atan, sin, cos, exp)
  differ by ulps on the CPU. Aspect is compared as an angle, mod 360.
- The weight table from the same updraft and potential: exact, in
  float32 and bfloat16 (the same float32 operations, the same
  round-to-nearest-even cast).
- The direct potential from the same conductivity: exact (the same numpy
  and scipy code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssrs_tpu.agents.moves as jmoves
import ssrs_tpu.agents.starts as jstarts
import ssrs_tpu.core.grid as jgrid
import ssrs_tpu.data.crs as jcrs
import ssrs_tpu.data.geotiff as jgeotiff
import ssrs_tpu.data.raster as jraster
import ssrs_tpu.data.synthetic as jsynth
import ssrs_tpu.fields as jfields
import ssrs_tpu.potential.boundary as jboundary
from ssrs_tpu.agents.simulate import prepared_weights as jprepared
from ssrs_tpu.potential.direct import solve_potential_direct as jdirect

import ssrs_tpu_torch.agents.moves as tmoves
import ssrs_tpu_torch.agents.starts as tstarts
import ssrs_tpu_torch.core.grid as tgrid
import ssrs_tpu_torch.data.crs as tcrs
import ssrs_tpu_torch.data.geotiff as tgeotiff
import ssrs_tpu_torch.data.raster as traster
import ssrs_tpu_torch.data.synthetic as tsynth
import ssrs_tpu_torch.fields as tfields
import ssrs_tpu_torch.potential.boundary as tboundary
from ssrs_tpu_torch.agents.simulate import (prepared_weights as tprepared,
                                            weights_from_numpy)
from ssrs_tpu_torch.potential.direct import \
    solve_potential_direct as tdirect

RTOL, ATOL = 1e-5, 1e-4
RES = 30.
WY = (-106.21, 42.78)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# ---- host copies: exact -------------------------------------------------

@pytest.mark.parametrize('width,res', [((12., 10.), 200.),
                                       ((60., 50.), 100.)])
def test_grid_copy(width, res):
    sw = (-1e5, 2e5)
    a = jgrid.Grid.from_region(width, res, sw)
    b = tgrid.Grid.from_region(width, res, sw)
    assert (a.shape, a.bounds, a.extent) == (b.shape, b.bounds, b.extent)
    assert (a.burnin_length(), a.reference_max_moves()) == \
        (b.burnin_length(), b.reference_max_moves())
    for x, y in zip(a.xy_grid(), b.xy_grid()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('dirn', [0., 37.5, 90., 215., 300.])
def test_move_tables_copy(dirn):
    np.testing.assert_array_equal(jmoves.restriction_table(),
                                  tmoves.restriction_table())
    np.testing.assert_array_equal(jmoves.directional_probs(dirn),
                                  tmoves.directional_probs(dirn))
    for name in ('NEIGHBOR_DELTAS', 'NEIGHBOR_NORMS_INV', 'CENTER_ZERO'):
        np.testing.assert_array_equal(getattr(jmoves, name),
                                      getattr(tmoves, name))


@pytest.mark.parametrize('stype', ['random', 'structured'])
def test_starts_copy(stype):
    args = (5000, [1., 11., 1., 2.], stype, (12., 10.), 200.)
    a = jstarts.get_starting_indices(*args, rng=np.random.default_rng(3))
    b = tstarts.get_starting_indices(*args, rng=np.random.default_rng(3))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('dirn', [0., 45., 135., 200., 330.])
def test_boundary_copy(dirn):
    for x, y in zip(jboundary.boundary_nodes(dirn, (50, 60)),
                    tboundary.boundary_nodes(dirn, (50, 60))):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jboundary.boundary_masks(dirn, (50, 60)),
                    tboundary.boundary_masks(dirn, (50, 60))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('crs', ['ESRI:102008', 'EPSG:32613'])
def test_crs_copy(crs):
    rng = np.random.default_rng(4)
    lon = -106.5 + rng.random(200)
    lat = 42.5 + rng.random(200)
    for x, y in zip(jcrs.transform_coordinates('EPSG:4326', crs, lon, lat),
                    tcrs.transform_coordinates('EPSG:4326', crs, lon, lat)):
        np.testing.assert_array_equal(x, y)
    bounds = (-106.3, 42.7, -106.0, 42.9)
    assert jcrs.transform_bounds(bounds, 'EPSG:4326', crs) == \
        tcrs.transform_bounds(bounds, 'EPSG:4326', crs)
    assert jcrs.get_utm_string(-106.2) == tcrs.get_utm_string(-106.2)


def test_synthetic_dem_and_raster_copy(tmp_path):
    """The synthetic DEM, its GeoTIFF round trip and its reprojection
    onto the run grid are equal bit for bit."""
    bnds = (-106.22, 42.77, -106.05, 42.88)
    a, ab = jsynth.synthetic_dem_lonlat(bnds)
    b, bb = tsynth.synthetic_dem_lonlat(bnds)
    np.testing.assert_array_equal(a, b)
    assert ab == bb
    fj, ft = str(tmp_path / 'j.tif'), str(tmp_path / 't.tif')
    jsynth.SyntheticTerrain('SYNTHETIC', bnds, fj).download()
    tsynth.SyntheticTerrain('SYNTHETIC', bnds, ft).download()
    ij, it = jgeotiff.read_geotiff(fj), tgeotiff.read_geotiff(ft)
    np.testing.assert_array_equal(ij.data, it.data)
    assert (ij.bounds, ij.crs_code) == (it.bounds, it.crs_code)
    grid = tgrid.Grid.from_region((12., 10.), 200., tuple(
        float(np.asarray(v).ravel()[0]) for v in tcrs.transform_coordinates(
            'EPSG:4326', 'ESRI:102008', *WY)))
    rj = jraster.get_raster_in_projected_crs(fj, grid.bounds, grid.shape,
                                             200., 'ESRI:102008')
    rt = traster.get_raster_in_projected_crs(ft, grid.bounds, grid.shape,
                                             200., 'ESRI:102008')
    np.testing.assert_array_equal(rj, rt)


# ---- fields: float32 tolerance ------------------------------------------

def _angle_close(a, b):
    d = np.mod(np.asarray(a, np.float64) - np.asarray(b, np.float64), 360.)
    d = np.minimum(d, 360. - d)
    assert np.all(d <= ATOL + RTOL * np.abs(b)), float(d.max())


def test_slope_aspect(synthetic_dem):
    dem32 = synthetic_dem.astype(np.float32)
    np.testing.assert_allclose(
        tfields.compute_slope_degrees(_t(dem32), RES).numpy(),
        np.asarray(jfields.compute_slope_degrees(dem32, RES)),
        rtol=RTOL, atol=ATOL)
    _angle_close(tfields.compute_aspect_degrees(_t(dem32), RES).numpy(),
                 np.asarray(jfields.compute_aspect_degrees(dem32, RES)))
    from ssrs_tpu.fields.terrain import compute_slope_aspect_degrees
    js, ja = compute_slope_aspect_degrees(dem32, RES)
    ts, ta = tfields.compute_slope_aspect_degrees(_t(dem32), RES)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    _angle_close(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize('wdirn', [0., 270.])
def test_orographic_updraft_and_threshold(synthetic_dem, wdirn):
    dem32 = synthetic_dem.astype(np.float32)
    slope = np.asarray(jfields.compute_slope_degrees(dem32, RES))
    aspect = np.asarray(jfields.compute_aspect_degrees(dem32, RES))
    speed = np.full(dem32.shape, 10., np.float32)
    dirn = np.full(dem32.shape, wdirn, np.float32)
    jo = np.asarray(jfields.compute_orographic_updraft(speed, dirn, slope,
                                                       aspect))
    to = tfields.compute_orographic_updraft(_t(speed), _t(dirn), _t(slope),
                                            _t(aspect)).numpy()
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    for thr in (0.75, 1.5):
        np.testing.assert_allclose(
            tfields.get_above_threshold_speed(_t(jo), thr).numpy(),
            np.asarray(jfields.get_above_threshold_speed(jo, thr)),
            rtol=RTOL, atol=ATOL)
    from ssrs_tpu.fields.updraft import orographic_updraft_from_dem
    np.testing.assert_allclose(
        tfields.orographic_updraft_from_dem(_t(dem32), RES, _t(speed),
                                            _t(dirn)).numpy(),
        np.asarray(orographic_updraft_from_dem(dem32, RES, speed, dirn)),
        rtol=RTOL, atol=ATOL)


# ---- weight table and direct potential: exact ---------------------------

def _updraft_potential(shape=(48, 56)):
    rng = np.random.default_rng(12)
    up = rng.random(shape).astype(np.float32) * 3.
    up[rng.random(shape) < 0.3] = 0.
    pot = tdirect(up, 30.)
    return up, pot


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('dirn', [0., 30.])
def test_weight_table(dtype, dirn):
    up, pot = _updraft_potential()
    dirp = jmoves.directional_probs(dirn)
    want = np.asarray(jprepared(jnp.asarray(up), jnp.asarray(pot),
                                jnp.asarray(dirp), dtype))
    got = tprepared(_t(up), _t(pot), _t(dirp), dtype)
    assert got.dtype == (torch.float32 if dtype == 'float32'
                         else torch.bfloat16)
    assert torch.equal(got, weights_from_numpy(want, 'cpu'))


def test_weight_dtype_auto_rule():
    """'auto' picks float32 up to 6 MiB of float32 table, bfloat16 above
    (500x600 is 10.3 MiB), as the JAX package does."""
    from ssrs_tpu.agents.simulate import resolve_weight_dtype as jr
    from ssrs_tpu_torch.agents.simulate import resolve_weight_dtype as tr
    for shape in [(50, 60), (400, 436), (500, 600)]:
        assert jr('auto', shape) == tr('auto', shape)
    assert tr('auto', (500, 600)) == 'bfloat16'


@pytest.mark.parametrize('dirn', [0., 135.])
def test_direct_potential_exact(dirn):
    up, _ = _updraft_potential((30, 36))
    np.testing.assert_array_equal(tdirect(up, dirn), jdirect(up, dirn))
