"""The port's refined potential solver against the JAX package and the
float64 direct solve, on the CPU.

Inputs come from numpy seeds and go through both packages. Tolerances:

- Weight planes: equal up to 1 float32 ulp. Both packages compute the
  same float32 formulas; the last bit of the harmonic mean may differ
  where XLA and torch round a reciprocal or division differently.
- Transfers: exact against the strided oracle (the port's coarsening is
  that oracle's sum order); against JAX's parity-mask ``reduce_window``
  within a few float32 ulps of the summed values (another sum order).
  Prolongation and the Dirichlet-mask coarsening are exact.
- Stencil applies: ``rtol=1e-6`` on random iterates (the same op order;
  XLA may contract or reorder).
- Host island code: exact (copies of the JAX functions).
- Per-island sums: float64, ``rtol=1e-12`` against numpy's float64
  ``bincount``; ``island_zaz`` against JAX's float32 sums at ``rtol=1e-5``.
- One V-cycle on a field without islands: ``rtol=1e-4`` of the iterate's
  scale (float32 reductions in another order, over 8 levels).
- Whole solves: held against the direct solve at the JAX package's own
  bounds (tests/test_potential.py). On thresholded fields both float32
  solvers may stop anywhere along a near-null mode that no float32
  residual sees (ROADMAP.md section 3), so there the check is the
  invariants: scaled residual, the float64 interior residual, the bounds
  and the exact boundary.
"""

import jax
import numpy as np
import pytest
import requests
import torch

import jax.numpy as jnp
from ssrs_tpu.potential import lap as jlap
from ssrs_tpu.potential import solver as jsolver
from ssrs_tpu.potential import solve_potential_refined as jrefined

import ssrs_tpu_torch
from ssrs_tpu_torch.potential import (boundary_masks, solve_potential_direct,
                                      solve_potential_refined)
from ssrs_tpu_torch.potential import lap as tlap
from ssrs_tpu_torch.potential import solver as tsolver
from ssrs_tpu_torch.potential.direct import interior_residual
from ssrs_tpu_torch.potential.fields import conductivity_hard, speckle

from test_potential import _conductivity_hard, _conductivity_moderate


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    """Every HTTP request of this module is refused: both packages' terrain
    chains then end at the synthetic DEM and their turbine fetches at
    None."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """A solve is tens of thousands of small ops. Beside the other test
    workers, every op's thread-pool barrier waits for busy cores (the
    460x460 solve took 133 s instead of 7 s), so this module runs torch
    on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _solve(cond, dirn=0., **kw):
    """(port potential float64, rrel, direct potential float64)."""
    bmask, bvals = boundary_masks(dirn, cond.shape)
    got, rrel = solve_potential_refined(cond, bmask, bvals, device='cpu',
                                        **kw)
    want = solve_potential_direct(cond, dirn).astype(np.float64)
    return got.numpy().astype(np.float64), rrel, want


def _ulps_apart(a, b):
    """Per-element distance in float32 ulps."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize('shape,seed', [((24, 30), 1), ((460, 460), 1),
                                        ((33, 47), 4)])
def test_card_fields_copy_the_jax_tests_field(shape, seed):
    """The field the card's checks solve (chip_smoke.py and the gpu
    tests, which run without JAX) is the JAX tests' own."""
    np.testing.assert_array_equal(conductivity_hard(shape, seed=seed),
                                  _conductivity_hard(shape, seed=seed))


# ---- operator ---------------------------------------------------------------


@pytest.mark.parametrize('shape,seed', [((7, 9), 3), ((33, 47), 4),
                                        ((20, 25), 5)])
def test_planes_match_jax(shape, seed):
    cond = _conductivity_hard(shape, seed=seed)
    cond[0, :3] = 0.          # zero edges at the boundary too
    wt = tsolver.weight_planes(_t(cond))
    wj = jlap.weight_planes(jnp.asarray(cond))
    assert wt.dtype == torch.float32 and wt.shape == (8,) + shape
    assert _ulps_apart(wt.numpy(), wj).max() <= 1
    st = tlap.symmetrize_planes(wt)
    sj = jlap.symmetrize_planes(jnp.asarray(wt.numpy()))
    assert _ulps_apart(st.numpy(), sj).max() <= 1
    pt = tsolver.transition_planes(_t(cond))
    pj = jsolver.transition_planes(jnp.asarray(cond))
    assert _ulps_apart(pt.numpy(), pj).max() <= 1
    np.testing.assert_allclose(pt.sum(0).numpy(), 1., rtol=1e-6)


def test_operator_skew_confined_to_east_strip():
    """The east-column fac quirk makes the port's W nonsymmetric only on
    edges with both ends in the two easternmost columns, and
    symmetrize_planes removes it (tests/test_potential.py's pin, on the
    port's planes)."""
    rng = np.random.default_rng(3)
    w = speckle(rng, (20, 25), 0.4)
    planes = tsolver.weight_planes(_t(w))
    ncol = w.shape[1]
    cols = set()
    for k, (dr, dc) in enumerate(tlap._DELTAS):
        kopp = tlap._DELTA_TO_K[(-dr, -dc)]
        w_opp = tsolver._shift(planes[kopp], dr, dc).numpy()
        for r, c in zip(*np.nonzero(np.abs(planes[k].numpy() - w_opp)
                                    > 1e-9)):
            cols.update((c, c + dc))
    assert cols, 'expected the east-strip skew to exist'
    assert cols <= {ncol - 2, ncol - 1}, f'skew outside east strip: {cols}'
    sym = tlap.symmetrize_planes(planes)
    for k, (dr, dc) in enumerate(tlap._DELTAS):
        kopp = tlap._DELTA_TO_K[(-dr, -dc)]
        s_opp = tsolver._shift(sym[kopp], dr, dc).numpy()
        mask = sym[k].numpy() > 0
        np.testing.assert_allclose(sym[k].numpy()[mask], s_opp[mask],
                                   atol=1e-9)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_apply_lap_matches_jax(dtype):
    rng = np.random.default_rng(6)
    shape = (37, 52)
    cond = speckle(rng, shape, 0.6)
    planes = tsolver.weight_planes(_t(cond))
    u = (rng.random(shape) * 1000.).astype(np.float32)
    labels, k = tlap.island_labels(cond, boundary_masks(0., shape)[0])
    assert k > 10
    want = np.asarray(jlap._apply_lap(jnp.asarray(planes.numpy()),
                                      jnp.asarray(u)))
    want_x = np.asarray(jlap._apply_lap_crossing(
        jnp.asarray(planes.numpy()), jnp.asarray(labels), jnp.asarray(u)))
    tp = planes.to(torch.float64) if dtype == np.float64 else planes
    tu = _t(u.astype(dtype))
    got = tlap._apply_lap(tp, tu)
    got_x = tlap._apply_lap_crossing(tp, _t(labels.astype(np.int64)), tu)
    assert got.dtype == tu.dtype
    for g, w in ((got, want), (got_x, want_x)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())
    assert not np.allclose(want, want_x)   # islands cut some edges


# ---- transfers --------------------------------------------------------------


def _strided_oracle(planes):
    wp = np.asarray(jlap._pad_even(jnp.asarray(planes)))
    mc, nc = wp.shape[-2] // 2, wp.shape[-1] // 2
    coarse = [np.zeros((mc, nc), wp.dtype) for _ in range(8)]
    for k, (dr, dc) in enumerate(jlap._DELTAS):
        for i in (0, 1):
            for j in (0, 1):
                di, dj = (i + dr) // 2, (j + dc) // 2
                if (di, dj) == (0, 0):
                    continue
                kc = jlap._DELTA_TO_K[(di, dj)]
                coarse[kc] = coarse[kc] + wp[k][i::2, j::2]
    return np.stack(coarse)


@pytest.mark.parametrize('shape', [(17, 23), (64, 64), (101, 30)])
def test_transfers_match_jax_and_strided_oracle(shape):
    rng = np.random.default_rng(shape[0])
    planes = rng.random((8,) + shape).astype(np.float32)
    got = tlap._galerkin_coarsen(_t(planes)).numpy()
    np.testing.assert_array_equal(got, _strided_oracle(planes))
    want = np.asarray(jlap._galerkin_coarsen(jnp.asarray(planes)))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)

    r = (rng.random(shape) - 0.5).astype(np.float32)
    rp = np.pad(r, ((0, shape[0] % 2), (0, shape[1] % 2)))
    oracle = rp[::2, ::2] + rp[::2, 1::2] + rp[1::2, ::2] + rp[1::2, 1::2]
    got = tlap._restrict(_t(r)).numpy()
    scale = (np.abs(rp[::2, ::2]) + np.abs(rp[::2, 1::2])
             + np.abs(rp[1::2, ::2]) + np.abs(rp[1::2, 1::2]))
    for want in (oracle, np.asarray(jlap._restrict(jnp.asarray(r)))):
        assert (np.abs(got - want) <= 4 * np.finfo(np.float32).eps
                * scale).all()

    bmask = rng.random(shape) > 0.9
    np.testing.assert_array_equal(
        tlap._coarsen_bmask(_t(bmask)).numpy(),
        np.asarray(jlap._coarsen_bmask(jnp.asarray(bmask))))

    e = rng.random(((shape[0] + 1) // 2, (shape[1] + 1) // 2)) \
        .astype(np.float32)
    got = tlap._prolong_pc(_t(e), shape).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jlap._prolong_pc(jnp.asarray(e), shape)))
    np.testing.assert_array_equal(
        got, np.kron(e, np.ones((2, 2), np.float32))[:shape[0], :shape[1]])


# ---- islands ----------------------------------------------------------------


def test_island_host_code_matches_jax():
    rng = np.random.default_rng(7)
    for shape, thr in (((33, 47), 0.75), ((64, 80), 0.8), ((41, 90), 0.7)):
        cond = speckle(rng, shape, thr)
        bmask, _ = boundary_masks(45., shape)
        lt, kt = tlap.island_labels(cond, bmask)
        lj, kj = jlap.island_labels(cond, bmask)
        assert kt == kj > 0
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(tlap.island_labels(cond > 0, bmask)[0],
                                      lj)
        np.testing.assert_array_equal(tlap.island_sound_mask(lt, kt + 1),
                                      jlap.island_sound_mask(lj, kt + 1))
        for a, b in zip(tlap._host_coarsen_labels(lt, bmask),
                        jlap._host_coarsen_labels(lj, bmask)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('shape,nlab', [((48, 80), 97), ((37, 61), 5)])
def test_island_sums_and_zaz(shape, nlab):
    rng = np.random.default_rng(nlab)
    labels = rng.integers(0, nlab, size=shape).astype(np.int32)
    labels[:, :3] = 0
    num = nlab + 2          # the last island has no cell
    seg = tlap.island_segments(labels, num, 'cpu')
    x = (rng.random(shape) - 0.5).astype(np.float32)
    got = tlap.island_sum(_t(x), seg)
    assert got.dtype == torch.float64 and got.shape == (num,)
    want = np.bincount(labels.ravel(), weights=x.ravel().astype(np.float64),
                       minlength=num)
    want[0] = 0.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    c = rng.random(num)
    np.testing.assert_array_equal(_t(c)[seg.labels].numpy(), c[labels])

    planes = tsolver.weight_planes(_t(speckle(rng, shape, 0.4)))
    zaz = tlap.island_zaz(planes, seg).numpy()
    lab = labels
    labpad = np.pad(lab, 1, constant_values=-1)
    total = np.zeros(shape)
    for k, (dr, dc) in enumerate(tlap._DELTAS):
        nb = labpad[1 + dr:1 + dr + shape[0], 1 + dc:1 + dc + shape[1]]
        total += np.where((lab > 0) & (nb != lab),
                          planes[k].numpy().astype(np.float64), 0.)
    want = np.maximum(np.bincount(lab.ravel(), weights=total.ravel(),
                                  minlength=num), 1e-30)
    want[0] = 1.
    np.testing.assert_allclose(zaz, want, rtol=1e-12, atol=0)

    tiles = jlap._build_tile_hierarchy_host(labels, np.zeros(shape, bool))[0]
    zj = np.asarray(jlap.island_zaz(
        jnp.asarray(planes.numpy()), jnp.asarray(labels),
        jnp.asarray(tiles.lidx), jnp.asarray(tiles.slot_iota),
        jnp.asarray(tiles.sidx), jnp.asarray(tiles.sisland), num,
        jnp.asarray(tiles.ocell), jnp.asarray(tiles.oisland)))
    np.testing.assert_allclose(zaz, zj, rtol=1e-5)


def test_vcycle_matches_jax_without_islands():
    shape = (48, 52)
    cond = _conductivity_moderate(shape, seed=2)
    bmask, bvals = boundary_masks(0., shape)
    labels, k = tlap.island_labels(cond, bmask)
    assert k == 0
    planes = tlap.symmetrize_planes(tsolver.weight_planes(_t(cond)))
    levels = tlap.build_lap_levels(planes, _t(bmask), labels, 1)
    assert [lv.shape for lv in levels][-1] == (3, 4) and len(levels) == 5
    rng = np.random.default_rng(8)
    rhs = ((rng.random(shape) - 0.5) * ~bmask).astype(np.float32)
    got = tlap.vcycle(levels, _t(rhs), torch.zeros(shape)).numpy()

    tiles = jlap.build_tile_hierarchy(labels, bmask)
    jlevels = jlap.build_lap_levels(jnp.asarray(planes.numpy()),
                                    jnp.asarray(bmask), tiles, 256)
    want = np.asarray(jax.jit(lambda r: jlap.vcycle(
        jlevels, r, jnp.zeros(shape, jnp.float32)))(jnp.asarray(rhs)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# ---- whole solves against the direct solve ------------------------------------


@pytest.mark.parametrize('dirn', [0., 45., 90.])
def test_refined_matches_direct_hard(dirn):
    got, rrel, want = _solve(_conductivity_hard((24, 30), seed=1), dirn)
    assert np.abs(got - want).max() < 1e-2
    assert rrel < 1e-5


def test_refined_matches_direct_at_scale():
    """460x460 = 211k nodes, the JAX package's scale test."""
    stats = {}
    got, rrel, want = _solve(_conductivity_hard((460, 460), seed=1),
                             stats=stats)
    err = np.abs(got - want).max()
    assert err < 1.0, f'max abs err {err} out of 1000'
    assert rrel < 1e-5
    assert stats['passes'] >= 1 and stats['vcycles'] >= stats['passes']


def test_refined_warm_start_and_nan_init():
    shape = (48, 52)
    cond_a = _conductivity_hard(shape, seed=7)
    cond_b = _conductivity_hard(shape, seed=8)
    bmask, bvals = boundary_masks(0., shape)
    pot_a, _ = solve_potential_refined(cond_a, bmask, bvals, device='cpu')
    cold, _ = solve_potential_refined(cond_b, bmask, bvals, device='cpu')
    warm, rrel_warm = solve_potential_refined(cond_b, bmask, bvals,
                                              device='cpu', init=pot_a)
    assert rrel_warm < 1e-5
    assert (warm.double() - cold.double()).abs().max() < 1e-2
    bad = np.where(np.arange(shape[0] * shape[1]).reshape(shape) % 7 == 0,
                   np.nan, 250.).astype(np.float32)
    warm2, rrel2 = solve_potential_refined(cond_b, bmask, bvals,
                                           device='cpu', init=bad)
    assert rrel2 < 1e-5 and torch.isfinite(warm2).all()


@pytest.mark.parametrize('kind', ['moderate', 'ones', 'zeros'])
def test_refined_moderate_ones_zeros(kind):
    shape = (48, 52)
    cond = {'moderate': _conductivity_moderate(shape, seed=2),
            'ones': np.ones(shape, np.float32),
            'zeros': np.zeros(shape, np.float32)}[kind]
    got, _, want = _solve(cond)
    assert np.abs(got - want).max() < 1e-2


def _fuzz_fields():
    rng = np.random.default_rng(99)
    for shape in [(33, 47), (64, 64), (41, 90)]:
        for thr in [0.05, 0.5, 0.95]:
            yield shape, thr, speckle(rng, shape, thr)


def test_refined_fuzz_vs_direct():
    """The JAX package's 9-field fuzz: accurate or flagged above the 5e-3
    residual net, and none flagged."""
    n_flagged = 0
    for shape, thr, w in _fuzz_fields():
        got, rrel, want = _solve(w)
        err = np.abs(got - want).max()
        if err >= 1.0:
            assert rrel > 5e-3, ('silent bad solve', shape, thr, err, rrel)
            n_flagged += 1
    assert n_flagged == 0


def test_former_fuzz_stall_class_converges():
    w = [w for shape, thr, w in _fuzz_fields()
         if shape == (41, 90) and thr == 0.5][0]
    got, rrel, want = _solve(w)
    assert rrel < 1e-5
    assert np.abs(got - want).max() < 0.1


def test_strip_islands_adversarial_accurate_or_flagged():
    shape = (120, 160)
    cond = _conductivity_hard(shape, seed=7)
    cond[:, -6:] = 0.0
    cond[20:40, -3:] = 2.0
    cond[70:90, -2:] = 1.5
    got, rrel, want = _solve(cond)
    err = np.abs(got - want).max()
    assert err < 1.0 or rrel > 5e-3, f'silent bad solve: {err}, {rrel}'


@pytest.mark.parametrize('dirn,converges',
                         [(45., True), (135., True), (225., False),
                          (315., True)])
def test_refined_fuzz_directions(dirn, converges):
    """Accurate or flagged at every direction. The 225-degree field puts
    multi-cell floating islands on the east strip; JAX pins it flagged
    (rrel > 5e-3), and so does the port."""
    rng = np.random.default_rng(int(dirn))
    got, rrel, want = _solve(speckle(rng, (64, 64), 0.5), dirn)
    err = np.abs(got - want).max()
    assert err < 1.0 or rrel > 5e-3, f'silent bad solve: {err}, {rrel}'
    if converges:
        assert err < 1.0 and rrel < 1e-5
    else:
        assert rrel > 5e-3


def test_refined_is_deterministic():
    rng = np.random.default_rng(12)
    w = speckle(rng, (64, 80), 0.5)
    bmask, bvals = boundary_masks(0., w.shape)
    a, ra = solve_potential_refined(w, bmask, bvals, device='cpu')
    b, rb = solve_potential_refined(_t(w), bmask, bvals)
    assert torch.equal(a, b) and ra == rb


def test_numpy_input_needs_a_device():
    bmask, bvals = boundary_masks(0., (8, 9))
    with pytest.raises(ValueError, match='device'):
        solve_potential_refined(np.ones((8, 9), np.float32), bmask, bvals)


# ---- the WY field of the README's region, 12x10 km at 100 m ------------------


@pytest.fixture(scope='module')
def wy_field(tmp_path_factory):
    """The thresholded updraft of the tests' WY region at 100 m
    (100x120), as the port's Simulator computes it."""
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        run_name='wy100', out_dir=str(tmp_path_factory.mktemp('wy100')),
        sim_mode='uniform', southwest_lonlat=(-106.21, 42.78),
        region_width_km=(12., 10.), resolution=100., track_count=10),
        device='cpu')
    return sim.load_updrafts(sim.case_ids[0])[0].numpy()


@pytest.mark.parametrize('package', ['port', 'jax'])
def test_wy_field_invariants(wy_field, package):
    """Both packages' refined potentials on the 100x120 WY field: scaled
    residual, the float64 interior residual of the reference's system,
    the bounds and the exact boundary. (Elementwise they may differ
    from the direct solve by ~100/1000 along a near-null mode.)"""
    cond = wy_field
    assert cond.shape == (100, 120) and (cond == 0).mean() > 0.2
    bmask, bvals = boundary_masks(0., cond.shape)
    if package == 'port':
        pot, rrel = solve_potential_refined(cond, bmask, bvals, device='cpu')
        pot = pot.numpy()
    else:
        pot, rrel = jrefined(cond, bmask, bvals)
        pot = np.asarray(pot)
    assert pot.dtype == np.float32 and float(rrel) < 1e-5
    assert interior_residual(pot, cond, 0.) <= 2e-4
    assert pot.min() >= -1e-3 and pot.max() <= 1000. + 1e-3
    np.testing.assert_array_equal(pot[bmask], bvals[bmask])


def test_interior_residual_of_direct_is_small():
    cond = _conductivity_hard((24, 30), seed=1)
    pot = solve_potential_direct(cond, 45.)
    assert interior_residual(pot, cond, 45.) < 1e-4
    # a constant is in the null space (the rows of P sum to 1); one cell
    # is not
    assert interior_residual(pot + 7., cond, 45.) < 1e-3
    pot[12, 15] += 1.
    assert interior_residual(pot, cond, 45.) > 0.5
