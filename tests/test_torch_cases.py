"""The port's multi-case paths on the CPU: the batched table build, the
step and chunk without a table (the directed random walk), the cases
drivers, and the ``Simulator``'s direction sweep, thermal realizations and
drw runs.

- Tables: bit for bit against stacked single builds and against the JAX
  package's ``prepared_weights_batch``.
- The step without a table, with injected uniforms, against the JAX
  package's XLA step built with no table: exact at nu = 1 (the same
  float32 operations in the same order), >= 99.9% of moves at nu = 2
  (``exp(nu log p)`` against ``power``); the chunk's plain version against
  T such steps; the all-ones updraft and flat potential by which the JAX
  package's batched driver emulates the walk gives the same moves.
- ``simulate_presence_cases_compacting``: every case bit-identical to the
  single-case driver with the same seed, table and starts; against the
  JAX package's driver statistically (the generators differ), with the L1
  bound of ``tests/test_compaction.py``.
- The ``Simulator`` with ``device='cpu'``: the JAX package's sweep and
  scoring tests, ported; artifact names equal to the JAX package's.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu_torch
from ssrs_tpu.agents import simulate as jsim
from ssrs_tpu.agents.moves import directional_probs, restriction_table
from ssrs_tpu.agents.presence import smooth_presence as jsmooth

from ssrs_tpu_torch.agents import fused_chunk as fc
from ssrs_tpu_torch.agents import simulate as tsim
from ssrs_tpu_torch.agents.presence import smooth_presence as tsmooth

GRID = (48, 56)
N = 1024


def _fields(case=0):
    """Updraft and potential of case ``case``: the potential falls with
    the row, so agents drift toward high rows."""
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x + 0.7 * case) * np.sin(y))
    potential = np.linspace(1000., 0., nrow)[:, None] * np.ones((1, ncol)) \
        + 3. * case * np.cos(x)
    return updraft.astype(np.float32), potential.astype(np.float32)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_prepared_weights_batch_bit_for_bit(dtype):
    cases = 3
    ups = np.stack([_fields(i)[0] for i in range(cases)])
    pots = np.stack([_fields(i)[1] for i in range(cases)])
    ups[1, 10:14, 10:14] = 0.            # zero updraft: clipped to 1e-6
    dirps = np.stack([directional_probs(d) for d in (0., 90., 225.)])
    got = tsim.prepared_weights_batch(
        torch.from_numpy(ups), torch.from_numpy(pots),
        torch.from_numpy(dirps), dtype)
    assert got.shape == (cases, GRID[0] * GRID[1], 9)
    assert got.is_contiguous()
    want_jax = jsim.prepared_weights_batch(
        jnp.asarray(ups), jnp.asarray(pots), jnp.asarray(dirps), dtype)
    for i in range(cases):
        single = tsim.prepared_weights(
            torch.from_numpy(ups[i]), torch.from_numpy(pots[i]),
            torch.from_numpy(dirps[i]), dtype)
        assert torch.equal(_bits(got[i]), _bits(single))
        assert torch.equal(_bits(got[i]), _bits(tsim.weights_from_numpy(
            np.asarray(want_jax[i]), 'cpu')))


def _to_port(params, state):
    return tsim.state_from_numpy(
        params, np.asarray(state.pos_r), np.asarray(state.pos_c),
        np.asarray(state.mem), np.asarray(state.alive),
        np.asarray(state.palive), np.asarray(state.step),
        np.asarray(state.presence), device='cpu')


def _params(k, nu, nsteps=16, burnin=3, dtype='float32'):
    kw = dict(grid_shape=GRID, move_dirn=0., nu=nu, memory_k=k,
              burnin=burnin, nsteps=nsteps, weight_dtype=dtype)
    return jsim.TrackParams(step_impl='xla', **kw), tsim.TrackParams(**kw)


def _whole_grid_starts(rng, n):
    nrow, ncol = GRID
    starts = np.stack([rng.integers(0, nrow, n), rng.integers(0, ncol, n)],
                      axis=1).astype(np.int32)
    return starts, rng.random(n) < 0.9


@pytest.mark.parametrize('k', [0, 1, 3])
def test_no_table_step_exact_vs_jax(k):
    """20 steps without a table (across the burn-in of 3, past the cap of
    16) against the JAX package's XLA step with ``base_flat=None``: the
    whole state after every step, exactly."""
    rng = np.random.default_rng(400 + k)
    jp, tp = _params(k, 1.0)
    dirp = directional_probs(30.)
    jstep = jsim.make_step_fn(jp, None, jnp.asarray(dirp),
                              jnp.asarray(restriction_table()))
    tstep = tsim.make_step_fn(tp, None, torch.from_numpy(dirp),
                              torch.from_numpy(restriction_table()))
    starts, valid = _whole_grid_starts(rng, N)
    js = jsim.init_state(jp, starts, jax.random.key(0), valid=valid)
    ts = _to_port(tp, js)
    for _ in range(20):
        u = rng.random(N).astype(np.float32)
        js = jstep(js, u=jnp.asarray(u))
        ts = tstep(ts, u=torch.from_numpy(u))
        np.testing.assert_array_equal(ts.pos_r.numpy(), np.asarray(js.pos_r))
        np.testing.assert_array_equal(ts.pos_c.numpy(), np.asarray(js.pos_c))
        np.testing.assert_array_equal(ts.mem.numpy(), np.asarray(js.mem))
        np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    js = jsim.flush_pending(jp, js)
    ts = tsim.flush_pending(ts)
    np.testing.assert_array_equal(
        ts.presence.numpy(), np.asarray(js.presence)[:GRID[0], :GRID[1]])
    assert int(ts.presence.sum()) > N and not ts.alive.any()


def test_no_table_step_nu2_vs_jax():
    """nu = 2: the port raises by ``exp(nu log p)`` as the Pallas kernel
    does, the XLA step by ``power``; they may round apart on a rare
    draw."""
    rng = np.random.default_rng(410)
    jp, tp = _params(1, 2.0)
    dirp = directional_probs(30.)
    restr = restriction_table()
    jstep = jsim.make_step_fn(jp, None, jnp.asarray(dirp), jnp.asarray(restr))
    tstep = tsim.make_step_fn(tp, None, torch.from_numpy(dirp),
                              torch.from_numpy(restr))
    starts, _ = _whole_grid_starts(rng, 4 * N)
    js = jsim.init_state(jp, starts, jax.random.key(0))
    js = js._replace(mem=jnp.asarray(
        rng.integers(0, 9, (1, 4 * N)).astype(np.int32)))
    ts = _to_port(tp, js)
    u = rng.random(4 * N).astype(np.float32)
    js = jstep(js, u=jnp.asarray(u))
    ts = tstep(ts, u=torch.from_numpy(u))
    same = (ts.pos_r.numpy() == np.asarray(js.pos_r)) & \
        (ts.pos_c.numpy() == np.asarray(js.pos_c))
    assert same.mean() >= 0.999


def _chunk(params, table, state, u, dirp):
    fc.fused_chunk(table, torch.from_numpy(restriction_table()), dirp,
                   state.pos_r, state.pos_c, state.mem, state.alive,
                   state.palive, u, state.presence, nu=params.nu,
                   memory_k=params.memory_k, s0=state.step,
                   burnin=params.burnin, nsteps=params.nsteps)
    state.step = min(state.step + u.shape[0], params.nsteps)
    return state


@pytest.mark.parametrize('k', [0, 1, 3])
def test_no_table_chunk_equals_steps_and_emulation(k):
    """The chunk without a table: T steps at once equal T single steps
    (the port's, held to JAX's above), and equal the chunk on the table of
    an all-ones updraft and a flat potential, in float32 and in bfloat16:
    that table's rows are zero wherever a move can start, so the cascade
    falls to the prior."""
    rng = np.random.default_rng(420 + k)
    _, tp = _params(k, 1.0, nsteps=40)
    dirp = torch.from_numpy(directional_probs(30.))
    restr = torch.from_numpy(restriction_table())
    step = tsim.make_step_fn(tp, None, dirp, restr)
    starts, valid = _whole_grid_starts(rng, N)
    u = torch.from_numpy(rng.random((48, N)).astype(np.float32))
    stepped = tsim.init_state(tp, starts, valid=valid)
    for t in range(48):
        stepped = step(stepped, u=u[t])
    tables = [None] + [tsim.prepared_weights(
        torch.ones(GRID), torch.zeros(GRID), dirp, dtype)
        for dtype in ('float32', 'bfloat16')]
    for table in tables:
        chunked = tsim.init_state(tp, starts, valid=valid)
        chunked = _chunk(tp, table, chunked, u[:7], dirp)
        chunked = _chunk(tp, table, chunked, u[7:], dirp)
        for name in ('pos_r', 'pos_c', 'mem', 'alive', 'palive', 'presence'):
            assert torch.equal(getattr(chunked, name),
                               getattr(stepped, name)), name
        assert chunked.step == stepped.step == 40


def test_no_table_wrappers_check_operands():
    _, tp = _params(1, 1.0)
    dirp = torch.from_numpy(directional_probs(0.))
    state = tsim.init_state(tp, np.zeros((8, 2), np.int32) + 5)
    u = torch.rand(4, 8)
    with pytest.raises(ValueError, match='table must be None or'):
        _chunk(tp, torch.zeros(7, 9), state, u, dirp)
    with pytest.raises(ValueError, match='dirp'):
        _chunk(tp, None, state, u, dirp[:8])


def _norm_smooth(p, smooth):
    a = np.asarray(smooth(p, 3), np.float64)
    return a / a.sum()


def _low_starts(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(3, 6, n), rng.integers(10, 46, n)],
                    axis=1).astype(np.int32)


def _case_tables(dtype='float32', cases=3):
    dirp = torch.from_numpy(directional_probs(0.))
    return [tsim.prepared_weights(torch.from_numpy(_fields(i)[0]),
                                  torch.from_numpy(_fields(i)[1]), dirp, dtype)
            for i in range(cases)]


CASES_KW = dict(chunk=32, min_bucket=64)
SEEDS = (21, 22, 23, 24)


def _single_runs(tp, tables, starts, dirps=None, valid=None):
    return [tsim.simulate_presence_compacting(
        tp, starts[i], torch.Generator().manual_seed(SEEDS[i]),
        base_flat=tables[i], valid=valid,
        dirp=None if dirps is None else dirps[i], **CASES_KW)
        for i in range(len(tables))]


def _gens(n):
    return [torch.Generator().manual_seed(SEEDS[i]) for i in range(n)]


@pytest.mark.parametrize('starts_as', ['shared', 'stacked', 'list'])
def test_cases_compacting_bit_identical_to_single(starts_as):
    """Three table cases and a walk without a table: each case's map and
    step count equal the single-case driver's, whichever way the starts
    arrive."""
    _, tp = _params(1, 1.0, nsteps=200, burnin=4)
    tables = _case_tables() + [None]
    n = 700
    if starts_as == 'shared':
        starts = _low_starts(n, 5)
        per_case = [starts] * 4
    else:
        per_case = [_low_starts(n, 5 + i) for i in range(4)]
        starts = np.stack(per_case) if starts_as == 'stacked' else per_case
    presence, steps = tsim.simulate_presence_cases_compacting(
        tp, tables, starts, _gens(4), **CASES_KW)
    assert presence.shape == (4,) + GRID and presence.dtype == torch.int32
    assert steps.shape == (4,) and steps.dtype == np.int32
    for i, (want, want_steps) in enumerate(_single_runs(tp, tables,
                                                        per_case)):
        assert torch.equal(presence[i], want), i
        assert steps[i] == want_steps
        assert int(want.sum()) >= n * (tp.burnin + 1)
    # shared starts are not aliased between the cases' states
    assert not torch.equal(presence[0], presence[1])


def test_cases_compacting_early_death_dirps_valid_and_stacked_tables():
    """One case starts at the top rows and dies right after the burn-in
    while the others run on; per-case priors, a shared ``valid`` mask and
    stacked tables pass through: still bit-identical per case."""
    _, tp = _params(1, 1.0, nsteps=200, burnin=4)
    tables = torch.stack(_case_tables())
    n = 500
    rng = np.random.default_rng(9)
    top = np.stack([rng.integers(GRID[0] - 4, GRID[0] - 2, n),
                    rng.integers(10, 46, n)], axis=1).astype(np.int32)
    per_case = [_low_starts(n, 1), top, _low_starts(n, 2)]
    valid = rng.random(n) < 0.8
    dirps = torch.from_numpy(np.stack(
        [directional_probs(d) for d in (0., 45., 315.)]))
    presence, steps = tsim.simulate_presence_cases_compacting(
        tp, tables, per_case, _gens(3), dirps=dirps, valid=valid,
        **CASES_KW)
    singles = _single_runs(tp, tables, per_case, dirps=dirps, valid=valid)
    for i, (want, want_steps) in enumerate(singles):
        assert torch.equal(presence[i], want), i
        assert steps[i] == want_steps
    assert steps[1] == 32 < min(steps[0], steps[2])
    assert int(presence[1].sum()) >= int(valid.sum()) * (tp.burnin + 1)


def test_cases_compacting_accepts_auto_tail(monkeypatch):
    """``tail_bucket='auto'`` on the cases driver: each case runs its own
    rule; with a round trip of 0 s no case stops compacting early, so the
    maps are those of tail_bucket=0."""
    _, tp = _params(1, 1.0, nsteps=200, burnin=4)
    tables = _case_tables() + [None]
    rng = np.random.default_rng(4)
    starts = np.stack([rng.integers(2, GRID[0] - 2, 700),
                       rng.integers(2, GRID[1] - 2, 700)],
                      axis=1).astype(np.int32)
    want = tsim.simulate_presence_cases_compacting(
        tp, tables, starts, _gens(4), **CASES_KW)
    monkeypatch.setattr(tsim, '_dispatch_overhead', lambda device: 0.)
    monkeypatch.setattr(tsim, '_PER_SLOT', {})
    got = tsim.simulate_presence_cases_compacting(
        tp, tables, starts, _gens(4), tail_bucket='auto', **CASES_KW)
    assert torch.equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tsim._PER_SLOT[(tp, CASES_KW['chunk'], 'cpu')] > 0


def test_cases_compacting_rejects_bad_starts():
    _, tp = _params(1, 1.0, nsteps=50)
    tables = _case_tables(cases=2)
    starts = _low_starts(100, 3)
    with pytest.raises(ValueError, match='list has 3 entries for 2 cases'):
        tsim.simulate_presence_cases_compacting(
            tp, tables, [starts] * 3, _gens(2))
    with pytest.raises(ValueError, match='has 3 entries for 2 cases'):
        tsim.simulate_presence_cases_compacting(
            tp, tables, np.stack([starts] * 3), _gens(2))
    with pytest.raises(ValueError, match=r'must be \(N, 2\)'):
        tsim.simulate_presence_cases_compacting(
            tp, tables, starts[:, 0], _gens(2))


def test_cases_lockstep_engine_is_single_runs():
    """``simulate_presence_cases``: C runs of ``simulate_presence``."""
    _, tp = _params(1, 1.0, nsteps=60, burnin=4)
    tables = _case_tables(cases=2)
    dirps = torch.from_numpy(np.stack([directional_probs(0.)] * 2))
    starts = _low_starts(300, 4)
    presence, steps = tsim.simulate_presence_cases(
        tp, tables, dirps, starts, _gens(2), chunk=16)
    assert presence.shape == (2,) + GRID and steps.dtype == np.int32
    for i in range(2):
        want, want_steps = tsim.simulate_presence(
            tp, starts, torch.Generator().manual_seed(SEEDS[i]),
            base_flat=tables[i], dirp=dirps[i], chunk=16)
        assert torch.equal(presence[i], want) and steps[i] == want_steps


def test_cases_compacting_matches_jax_statistically():
    """On shared tables, case by case, against the JAX package's driver:
    the generators differ, so the smoothed maps are held to L1 < 0.08."""
    n = 4096
    jp, tp = _params(1, 1.0, nsteps=300, burnin=4, dtype='bfloat16')
    jp = jp._replace(step_impl='auto')
    ups = np.stack([_fields(i)[0] for i in range(2)])
    pots = np.stack([_fields(i)[1] for i in range(2)])
    dirp = directional_probs(0.)
    jtables = jsim.prepared_weights_batch(
        jnp.asarray(ups), jnp.asarray(pots),
        jnp.broadcast_to(jnp.asarray(dirp), (2, 9)), 'bfloat16')
    starts = _low_starts(n, 8)
    # the one-dispatch tail from the start: one XLA program a case instead
    # of one a bucket
    pj, sj = jsim.simulate_presence_cases_compacting(
        jp, jtables, starts, jax.random.split(jax.random.key(5), 2),
        chunk=64, min_bucket=256, tail_bucket=4096)
    ttables = [tsim.weights_from_numpy(np.asarray(jtables[i]), 'cpu')
               for i in range(2)]
    pt, st = tsim.simulate_presence_cases_compacting(
        tp, ttables, starts, _gens(2), chunk=64, min_bucket=256)
    for i in range(2):
        a = _norm_smooth(np.asarray(pj[i]), jsmooth)
        b = _norm_smooth(pt[i], tsmooth)
        assert np.abs(a - b).sum() < 0.08, i
        assert 0 < st[i] <= 300 and int(sj[i]) <= 300
        assert int(pt[i].sum()) >= n * (tp.burnin + 1)


# ---- the Simulator -------------------------------------------------------

SWEEP_CONFIG = dict(
    sim_mode='uniform', southwest_lonlat=(-106.21, 42.78), resolution=200.,
    movement_model='fluidflow')


def _port_sim(out, **kw):
    return ssrs_tpu_torch.Simulator(
        ssrs_tpu_torch.Config(out_dir=str(out), **{**SWEEP_CONFIG, **kw}),
        device='cpu')


@pytest.fixture(scope='module')
def sweep_sim(tmp_path_factory):
    return _port_sim(
        tmp_path_factory.mktemp('sweep'), run_name='sweep_test', sim_seed=12,
        region_width_km=(10., 8.), track_count=300,
        track_start_region=(1., 9., 1., 2.), track_max_steps=200)


def _counts(sim, case, model='fluidflow', real=0):
    return np.load(os.path.join(
        sim.mode_data_dir, f'{case}_d0_t75_{model}_r{real}_counts.npy'))


def test_direction_sweep(sweep_sim):
    cases = sweep_sim.simulate_direction_sweep([0., 90., 180., 270.])
    assert cases == ['s10d0', 's10d90', 's10d180', 's10d270']
    for case in cases:
        cmap = _counts(sweep_sim, case)
        assert cmap.dtype == np.int32 and cmap.sum() >= 300
        assert os.path.isfile(os.path.join(sweep_sim.mode_data_dir,
                                           f'{case}_orograph.npy'))
    # sweep cases feed the standard presence pipeline
    summary = sweep_sim.compute_presence_map(radius=600.)
    assert np.isclose(summary.max(), 1.0)
    # the batched engine leaves one structured phase record with the
    # useful-steps metric (presence mass minus start deposits)
    recs = [r for r in sweep_sim.timer.records
            if r['phase'] == 'batched_tracks']
    assert len(recs) == 1 and recs[0]['cases'] == 4
    total = sum(_counts(sweep_sim, c).sum(dtype=np.int64) for c in cases)
    assert recs[0]['useful_steps'] == total - 4 * 300
    assert recs[0]['seconds'] > 0 and len(recs[0]['steps']) == 4
    # one potential record a direction, naming its solver
    pots = [r for r in sweep_sim.timer.records if r['phase'] == 'potential']
    assert [r['id'] for r in pots] == [
        f'{c}_d0_t75_fluidflow_r0' for c in cases]
    assert all(r['solver'] in ('refined', 'direct') for r in pots)
    # the ctor's direction is one of the sweep's: the same orograph
    with pytest.raises(ValueError, match='uniform mode'):
        sweep_sim.sim_mode = 'seasonal'
        try:
            sweep_sim.simulate_direction_sweep([0.])
        finally:
            sweep_sim.sim_mode = 'uniform'


def test_sweep_cases_equal_single_case_runs(sweep_sim):
    """A sweep case's counts are those of the single-case compacting
    driver on that case's fields, generator and starts."""
    from ssrs_tpu_torch.core.rng import case_generator
    sweep_sim._rng = np.random.default_rng(7)
    cases = sweep_sim.simulate_direction_sweep([0., 90.])
    sweep_sim._rng = np.random.default_rng(7)
    starts = sweep_sim._starts()
    for case in cases:
        pot = np.load(os.path.join(
            sweep_sim.mode_data_dir,
            f'{case}_d0_t75_fluidflow_r0_potential.npy'))
        want, _ = tsim.simulate_presence_compacting(
            sweep_sim._track_params(), starts,
            case_generator(sweep_sim.sim_seed, case, 0, 'tracks', 'cpu'),
            updraft=sweep_sim.load_updrafts(case)[0],
            potential=torch.from_numpy(pot))
        np.testing.assert_array_equal(_counts(sweep_sim, case),
                                      want.numpy())


def test_device_resident_fields_match_host(tmp_path):
    """Config.fields_device keeps thresholded updrafts and potentials as
    tensors through the sweep prep; the artifacts must be bitwise
    identical to the host-materialized flow."""
    def run(fields_device, name):
        sim = _port_sim(
            tmp_path, run_name=name, sim_seed=5, region_width_km=(8., 6.),
            track_count=300, track_start_region=(1., 7., 1., 2.),
            track_max_steps=150, fields_device=fields_device)
        cases = sim.simulate_direction_sweep([0., 90.])
        arts = {}
        for c in cases:
            base = f'{c}_d0_t75_fluidflow_r0'
            for kind in ('counts', 'potential'):
                arts[f'{base}_{kind}'] = np.load(os.path.join(
                    sim.mode_data_dir, f'{base}_{kind}.npy'))
            arts[f'{c}_orograph'] = np.load(os.path.join(
                sim.mode_data_dir, f'{c}_orograph.npy'))
        return arts

    dev = run(True, 'dev_fields')
    host = run(False, 'host_fields')
    assert dev.keys() == host.keys() and len(dev) == 6
    for k in dev:
        np.testing.assert_array_equal(dev[k], host[k], err_msg=k)


def test_sweep_rerun_hits_potential_cache(sweep_sim, capsys):
    """A re-run sweep reuses the saved potential artifacts and, with the
    start rng pinned, reproduces identical presence counts."""
    def run():
        sweep_sim._rng = np.random.default_rng(99)
        capsys.readouterr()
        n_before = len(sweep_sim.timer.records)
        cases = sweep_sim.simulate_direction_sweep([0., 90.])
        out = capsys.readouterr().out
        assert out.count('Found saved potential') == len(cases)
        pots = [r for r in sweep_sim.timer.records[n_before:]
                if r['phase'] == 'potential']
        assert [r['solver'] for r in pots] == ['cache'] * len(cases)
        return {c: _counts(sweep_sim, c) for c in cases}

    sweep_sim.simulate_direction_sweep([0., 90.])   # fills the cache
    first = run()
    second = run()
    for c in first:
        np.testing.assert_array_equal(first[c], second[c], err_msg=c)


def test_device_fields_guard(sweep_sim):
    """The device-resident prep refuses to park case fields past the
    guard: never beyond 4096^2 cells, never more than ~1.5 GB."""
    assert sweep_sim._device_fields_fit(4)
    real = sweep_sim.gridsize
    try:
        sweep_sim.gridsize = (8192, 8192)
        assert not sweep_sim._device_fields_fit(1)
        sweep_sim.gridsize = (4096, 4096)
        assert sweep_sim._device_fields_fit(2)
        assert not sweep_sim._device_fields_fit(64)
        sweep_sim.gridsize = real
        sweep_sim.fields_device = False
        assert not sweep_sim._device_fields_fit(1)
    finally:
        sweep_sim.gridsize = real
        sweep_sim.fields_device = True


def test_fluidflow_thermals_batched_device_matches_host(tmp_path):
    """The batched multi-realization path (thermal realizations > 0,
    track_pkl_budget=0, so the multi-case driver runs) is bitwise
    identical between the device-resident and host-materialized prep
    flows; the presence map sums every realization."""
    def run(fields_device, name):
        sim = _port_sim(
            tmp_path, run_name=name, sim_seed=6, region_width_km=(8., 6.),
            track_count=200, track_start_region=(1., 7., 1., 2.),
            track_max_steps=120, thermals_realization_count=2,
            track_pkl_budget=0, fields_device=fields_device)
        sim.simulate_tracks()
        recs = [r for r in sim.timer.records
                if r['phase'] == 'batched_tracks']
        assert len(recs) == 1 and recs[0]['cases'] == 3
        arts = {}
        for c in sim.case_ids:
            for r in range(3):   # orograph + 2 thermal realizations
                arts[f'{c}_r{r}'] = _counts(sim, c, real=r)
        return arts, sim

    dev, sim = run(True, 'th_dev')
    host, _ = run(False, 'th_host')
    assert dev.keys() == host.keys() and len(dev) == 3
    for k in dev:
        np.testing.assert_array_equal(dev[k], host[k], err_msg=k)
    # the realizations' fields differ, so their counts do
    assert not np.array_equal(dev['s10d270_r0'], dev['s10d270_r1'])
    thermals = [np.load(os.path.join(sim.mode_data_dir,
                                     f's10d270_r{r}_thermals.npy'))
                for r in range(2)]
    for field in thermals:      # few cells: a field may hold no seed
        assert field.dtype == np.float32 and field.shape == sim.gridsize
        assert field.min() >= 0.
    # the summary over all three realizations, by hand
    krad = sim._presence_kernel_radius(600.)
    case_prob = np.zeros(sim.gridsize)
    for r in range(3):
        prob = tsmooth(torch.from_numpy(dev[f's10d270_r{r}']), krad).numpy()
        case_prob += prob / prob.max()
    case_prob /= case_prob.max()
    summary = sim.compute_presence_map(radius=600.)
    np.testing.assert_allclose(summary, case_prob / case_prob.max(),
                               rtol=1e-12)


def test_recorded_thermals_run_writes_one_pkl_a_realization(tmp_path):
    """At most track_pkl_budget tracks: the serial loop records every
    realization, and each ``.pkl`` recounts to its ``_counts.npy``."""
    sim = _port_sim(
        tmp_path, run_name='th_rec', sim_seed=6, region_width_km=(8., 6.),
        track_count=60, track_start_region=(1., 7., 1., 2.),
        track_max_steps=120, thermals_realization_count=1)
    sim.simulate_tracks()
    assert not [r for r in sim.timer.records
                if r['phase'] == 'batched_tracks']
    recs = [r for r in sim.timer.records if r['phase'] == 'tracks']
    assert [r['recorded'] for r in recs] == [True, True]
    for real in range(2):
        base = f's10d270_d0_t75_fluidflow_r{real}'
        with open(os.path.join(sim.mode_data_dir, f'{base}_tracks.pkl'),
                  'rb') as fobj:
            tracks = pickle.load(fobj)
        assert len(tracks) == 60 and tracks[0].dtype == np.int16
        recount = ssrs_tpu_torch.agents.compute_presence_counts(
            tracks, sim.gridsize, device='cpu')
        np.testing.assert_array_equal(recount,
                                      _counts(sim, 's10d270', real=real))


def test_drw_runs_have_no_potential(tmp_path):
    """The directed random walk: no potential phase or artifact, serial
    (one item) and batched (a sweep); a rerun reproduces the counts."""
    def run(name):
        sim = _port_sim(
            tmp_path, run_name=name, sim_seed=2, region_width_km=(8., 6.),
            track_count=200, track_start_region=(1., 7., 1., 2.),
            track_max_steps=150, movement_model='drw', track_pkl_budget=0)
        sim.simulate_tracks()
        cases = sim.simulate_direction_sweep([0., 90.])
        return sim, cases

    sim, cases = run('drw_a')
    names = os.listdir(sim.mode_data_dir)
    assert not [n for n in names if 'potential' in n]
    assert not [r for r in sim.timer.records if r['phase'] == 'potential']
    single = _counts(sim, 's10d270', model='drw')
    assert single.sum() >= 200 * (sim.grid.burnin_length() + 1)
    # the walk ignores the wind: the sweep's cases differ by their
    # generators alone, and each equals a single-case run without a table
    a, b = (_counts(sim, c, model='drw') for c in cases)
    assert a.sum() >= 200 and not np.array_equal(a, b)
    again, _ = run('drw_b')
    np.testing.assert_array_equal(single,
                                  _counts(again, 's10d270', model='drw'))
    np.testing.assert_array_equal(a, _counts(again, cases[0], model='drw'))


def test_unknown_movement_model_raises(tmp_path):
    sim = _port_sim(tmp_path, run_name='bad_model', region_width_km=(8., 6.),
                    track_count=10, track_start_region=(1., 7., 1., 2.),
                    movement_model='levy')
    with pytest.raises(ValueError, match="options: 'fluidflow', 'drw'"):
        sim.simulate_tracks()


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


def _artifacts(sim):
    return sorted(n for n in os.listdir(sim.mode_data_dir)
                  if n.endswith(('.npy', '.pkl')))


@pytest.mark.parametrize('model', ['fluidflow', 'drw'])
def test_artifact_names_equal_jax(tmp_path, model):
    """The same config through both packages: a thermal realization, the
    batched track phase, then a sweep of two directions; the data
    directories hold the same artifact names, arrays of the same dtypes
    and shapes."""
    config = dict(
        run_name='names', sim_seed=3, region_width_km=(8., 6.),
        track_count=64, track_start_region=(1., 7., 1., 2.),
        track_max_steps=60, thermals_realization_count=1,
        track_pkl_budget=0 if model == 'fluidflow' else 100,
        movement_model=model, potential_solver='direct',
        track_tail_bucket=4096, mesh_devices=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
            out_dir=str(tmp_path / 'jax'), **{**SWEEP_CONFIG, **config}))
        jax_sim.simulate_tracks()
        jax_sim.simulate_direction_sweep([0., 90.])
    port = _port_sim(tmp_path / 'port', **config)
    port.simulate_tracks()
    port.simulate_direction_sweep([0., 90.])
    assert _artifacts(port) == _artifacts(jax_sim)
    assert len(_artifacts(port)) >= 8
    for name in _artifacts(port):
        if name.endswith('.npy'):
            a = np.load(os.path.join(port.mode_data_dir, name))
            b = np.load(os.path.join(jax_sim.mode_data_dir, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
