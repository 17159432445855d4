"""The port's thermal, atmospheric and richdem fields against the JAX
package's.

Inputs are made from a seed with numpy and fed to both packages.
Deterministic functions agree to float32 tolerances (the transcendentals
of XLA and torch differ by ulps); ``compute_thermals`` draws from another
generator than JAX's (threefry and Philox never agree), so it is held
exactly where the field must be zero, and statistically in its mass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from ssrs_tpu import fields as jf
from ssrs_tpu.fields import thermals as jthermals

from ssrs_tpu_torch import fields as tf
from ssrs_tpu_torch.core.rng import case_generator

RTOL = 1e-5


def _dem(shape, seed):
    rng = np.random.default_rng(seed)
    y = np.linspace(0., 3., shape[0])[:, None]
    x = np.linspace(0., 4., shape[1])[None, :]
    z = 1500. + 300. * np.sin(x) * np.cos(y) + 20. * rng.random(shape)
    z[5:9, 5:9] = 1400.     # a flat patch: richdem's nodata aspect
    return z.astype(np.float32)


@pytest.mark.parametrize('sigma,truncate', [(4.0, 4.0), (1.5, 3.0),
                                            (0.8, 4.0)])
def test_gaussian_kernel1d_equal(sigma, truncate):
    got = tf.gaussian_kernel1d(sigma, truncate)
    want = jthermals.gaussian_kernel1d(sigma, truncate)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2 * int(truncate * sigma + 0.5) + 1,)


@pytest.mark.parametrize('shape', [(60, 50), (33, 70)])
def test_gaussian_filter_matches_jax_and_scipy(shape):
    """Sums of 33 float32 taps, twice: atol 1e-5 of the field's maximum
    against JAX's convolution and against scipy's float64 filter with
    zero padding."""
    rng = np.random.default_rng(3)
    field = (rng.random(shape) ** 8 * 40.).astype(np.float32)
    got = tf.gaussian_filter(torch.from_numpy(field)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    atol = 1e-5 * float(field.max())
    np.testing.assert_allclose(
        got, np.asarray(jf.gaussian_filter(jnp.asarray(field))),
        rtol=0, atol=atol)
    np.testing.assert_allclose(
        got, scipy.ndimage.gaussian_filter(
            field.astype(np.float64), sigma=4.0, mode='constant', cval=0.),
        rtol=0, atol=atol)


def test_gaussian_filter_leaves_tf32_setting():
    saved = torch.backends.cudnn.allow_tf32
    tf.gaussian_filter(torch.ones(40, 40))
    assert torch.backends.cudnn.allow_tf32 == saved


def test_atmosphere_matches_jax():
    rng = np.random.default_rng(4)
    shape = (60, 50)
    pot_t = (rng.random(shape) * 40. - 5.).astype(np.float32)
    blh = (rng.random(shape) * 2000.).astype(np.float32)     # some < 100
    flux = (rng.random(shape) * 400. - 100.).astype(np.float32)  # some < 0
    pressure = (8e4 + rng.random(shape) * 2e4).astype(np.float32)
    temp = (rng.random(shape) * 35. - 5.).astype(np.float32)
    zmat = (rng.random(shape) * 2500. - 100.).astype(np.float32)

    def t(*arrays):
        return [torch.from_numpy(a) for a in arrays]

    dear_t = tf.deardoff_velocity_function(*t(pot_t, blh, flux))
    dear_j = np.asarray(jf.deardoff_velocity_function(pot_t, blh, flux))
    np.testing.assert_allclose(dear_t.numpy(), dear_j, rtol=RTOL, atol=1e-7)
    assert dear_t.dtype == torch.float32
    assert float(dear_t.min()) == float(np.float32(1e-5))
    # the result is a Celsius temperature, a difference of two ~300 K
    # terms: float32 rounding of those is 3e-5 K
    np.testing.assert_allclose(
        tf.compute_potential_temperature(*t(pressure, temp)).numpy(),
        np.asarray(jf.compute_potential_temperature(pressure, temp)),
        rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(
        tf.compute_thermal_updraft(*t(zmat, dear_j, blh)).numpy(),
        np.asarray(jf.compute_thermal_updraft(zmat, dear_j, blh)),
        rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize('res', [100., 30.])
def test_richdem_stencils_match_jax(res):
    z = _dem((60, 50), 5)
    slope = tf.compute_slope_richdem_degrees(torch.from_numpy(z), res)
    aspect = tf.compute_aspect_richdem_degrees(torch.from_numpy(z), res)
    np.testing.assert_allclose(
        slope.numpy(), np.asarray(jf.compute_slope_richdem_degrees(z, res)),
        rtol=RTOL, atol=1e-4)
    want = np.asarray(jf.compute_aspect_richdem_degrees(z, res))
    got = aspect.numpy()
    nodata = want == -9999.
    np.testing.assert_array_equal(got == -9999., nodata)
    assert nodata[6:8, 6:8].all() and nodata[0].all() and nodata[:, -1].all()
    d = np.mod(got[~nodata].astype(np.float64) - want[~nodata], 360.)
    assert np.minimum(d, 360. - d).max() <= 1e-4 + RTOL * 360.
    # the interior slope is the reference-convention stencil's (the two
    # scale the elevations at other places: 1e-3 degrees of float32
    # rounding at 1500 m elevations on a 30 m grid)
    np.testing.assert_allclose(
        slope.numpy()[1:-1, 1:-1],
        tf.compute_slope_degrees(torch.from_numpy(z), res).numpy()[1:-1,
                                                                  1:-1],
        rtol=0, atol=1e-3)


THERMAL_SHAPE = (300, 300)
THERMAL_SCALE = 2.0
THERMAL_REPS = 16


def _aspect_field():
    rng = np.random.default_rng(25)
    return (rng.random(THERMAL_SHAPE) * 360.).astype(np.float32)


def _port_thermals(aspect, real_id):
    gen = case_generator(31, 'thermals_test', real_id, 'thermals', 'cpu')
    return tf.compute_thermals(gen, torch.from_numpy(aspect),
                               THERMAL_SCALE).numpy()


def test_compute_thermals_zero_border_and_seeded():
    """Seeds fall in the interior alone (a 10% border is excluded) and
    the filter reaches 16 cells, so the outer 30 - 16 cells are exactly
    zero; one seed gives one field."""
    aspect = _aspect_field()
    field = _port_thermals(aspect, 0)
    assert field.dtype == np.float32 and field.shape == THERMAL_SHAPE
    edge = int(0.1 * THERMAL_SHAPE[0]) - 16
    inner = np.zeros(THERMAL_SHAPE, bool)
    inner[edge:-edge, edge:-edge] = True
    assert (field[~inner] == 0.).all()
    assert field.min() >= 0. and field.max() > 0.
    np.testing.assert_array_equal(field, _port_thermals(aspect, 0))
    assert not np.array_equal(field, _port_thermals(aspect, 1))


def test_compute_thermals_mass_matches_expectation_and_jax():
    """The filter loses no mass (every seed is 30 cells from the edge, the
    filter reaches 16), so a field's sum is its seeds' mass, whose
    expectation is the sum over the interior of
    1/(floor(wtfactor) - 1) * exp(scale + 3 + 0.125). The mean over 16
    seeds lies within 10% of it, and of the JAX package's mean over 16
    keys."""
    aspect = _aspect_field()
    b = int(0.1 * THERMAL_SHAPE[0])
    wt = np.floor(1000. + np.abs(aspect[b:-b, b:-b].astype(np.float64)
                                 - 180.) / 180. * 2000.)
    expected = (1. / (wt - 1.)).sum() * np.exp(THERMAL_SCALE + 3. + 0.125)
    port = np.mean([_port_thermals(aspect, i).sum(dtype=np.float64)
                    for i in range(THERMAL_REPS)])
    keys = jax.random.split(jax.random.key(78), THERMAL_REPS)
    jax_mass = np.mean([float(np.asarray(
        jf.compute_thermals(k, aspect, THERMAL_SCALE)).sum()) for k in keys])
    assert abs(port / expected - 1.) < 0.10, (port, expected)
    assert abs(port / jax_mass - 1.) < 0.10, (port, jax_mass)
