"""Tests of the port's CUDA kernels and its card path (marker ``gpu``).

They skip without a CUDA device. This file imports no JAX, so it also
runs on a machine that has the card but no JAX:

    python -m pytest --noconftest -m gpu -q tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest.py configures JAX.)
"""

import os

import numpy as np
import pytest
import torch

import ssrs_tpu_torch
from ssrs_tpu_torch.agents import fused_chunk as fc
from ssrs_tpu_torch.agents import fused_step as fs
from ssrs_tpu_torch.agents import simulate as tsim
from ssrs_tpu_torch.agents import presence_hist as ph
from ssrs_tpu_torch.agents.moves import directional_probs, restriction_table
from ssrs_tpu_torch.agents.presence import smooth_presence
from ssrs_tpu_torch.potential.fields import conductivity_hard, speckle

pytestmark = pytest.mark.gpu

GRID = (48, 56)
N = 2000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(seed, k, dtype, dev):
    """All-zero and sparse table rows, dead agents, palive 0 and random
    memory: every branch of the cascade runs."""
    rng = np.random.default_rng(seed)
    nrow, ncol = GRID
    table = (rng.random((nrow * ncol, 9)) * 50.).astype(np.float32)
    kind = rng.random(nrow * ncol)
    table[kind < 0.2] = 0.
    sparse = (kind >= 0.2) & (kind < 0.5)
    table[sparse] *= rng.random((int(sparse.sum()), 9)) < 0.2
    table[:, 4] = 0.
    ints = dict(pr=rng.integers(1, nrow - 1, N),
                pc=rng.integers(1, ncol - 1, N),
                r=rng.integers(0, nrow, N), c=rng.integers(0, ncol, N),
                mem=rng.integers(0, 9, (max(k, 1), N)))
    args = {key: torch.from_numpy(v.astype(np.int32)).to(dev)
            for key, v in ints.items()}
    args['alive'] = torch.from_numpy(rng.random(N) < 0.85).to(dev)
    args['palive'] = torch.from_numpy(rng.random(N) < 0.85).to(dev)
    args['u'] = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
    return torch.from_numpy(table).to(dev).to(dtype), args


def _call(fn, table, a, presence, nu, k):
    dev = presence.device
    return fn(table, torch.from_numpy(restriction_table()).to(dev),
              torch.from_numpy(directional_probs(0.)).to(dev), a['pr'],
              a['pc'], a['r'], a['c'], a['alive'], a['palive'], a['mem'],
              a['u'], presence, nu=nu, memory_k=k)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k', [0, 1, 3])
@pytest.mark.parametrize('nu', [1.0, 0.0])
def test_kernel_matches_plain_on_card(cuda, dtype, k, nu):
    table, a = _inputs(k + 10 * int(nu), k, dtype, cuda)
    pk = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    pp = torch.zeros_like(pk)
    out_k = _call(fs.fused_step, table, a, pk, nu, k)
    out_p = _call(fs.fused_step_plain, table, a, pp, nu, k)
    torch.cuda.synchronize()
    for x, y in zip(out_k + (pk,), out_p + (pp,)):
        assert torch.equal(x, y)


def test_launch_counter_counts_card_launches(cuda):
    table, a = _inputs(1, 1, torch.float32, cuda)
    fs.reset_launch_count()
    pres = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    for _ in range(3):
        _call(fs.fused_step, table, a, pres, 1.0, 1)
    _call(fs.fused_step_plain, table, a, pres, 1.0, 1)
    assert fs.launch_count() == 3


def test_wrapper_rejects_mixed_devices(cuda):
    table, a = _inputs(2, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match='on'):
        _call(fs.fused_step, table.cpu(), a,
              torch.zeros(GRID, dtype=torch.int32, device=cuda), 1.0, 1)


def _chunk_inputs(seed, k, dtype, t_len, dev):
    """A table with all-zero and sparse rows, and a state over the whole
    grid (border cells included) with dead agents, palive 0 and random
    memory; most agents die at the boundary within a few hundred steps."""
    table, a = _inputs(seed, k, dtype, dev)
    rng = np.random.default_rng(seed + 1)
    state = dict(r=a['r'].clone(), c=a['c'].clone(), mem=a['mem'].clone(),
                 alive=a['alive'].clone(), palive=a['palive'].clone())
    u = torch.from_numpy(rng.random((t_len, N)).astype(np.float32)).to(dev)
    return table, state, u


def _noise_emission(t_len, seed, dev):
    """Emission rows filled with noise, so that an unwritten row shows."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.integers(-999, 999, (t_len, N, 2))
                           .astype(np.int16)).to(dev)
    flags = torch.from_numpy(rng.random((t_len, N)) < 0.5).to(dev)
    return pos, flags


def _chunk_call(fn, table, st, u, presence, nu, k, s0, nsteps, emit):
    dev = presence.device
    fn(table, torch.from_numpy(restriction_table()).to(dev),
       torch.from_numpy(directional_probs(0.)).to(dev), st['r'], st['c'],
       st['mem'], st['alive'], st['palive'], u, presence, nu=nu, memory_k=k,
       s0=s0, burnin=5, nsteps=nsteps, emit=emit)


@pytest.mark.parametrize('t_len', [1, 37, 512])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k', [0, 1, 3])
@pytest.mark.parametrize('nu', [1.0, 0.0])
def test_chunk_kernel_matches_plain_on_card(cuda, t_len, dtype, k, nu):
    """The chunk kernel against its plain version on the card, from step
    2 (across the burn-in of 5) to a cap a quarter of the window before
    its end: the state, presence and emission rows exactly equal."""
    seed = t_len + 7 * k + int(nu)
    table, st_k, u = _chunk_inputs(seed, k, dtype, t_len, cuda)
    st_p = {name: v.clone() for name, v in st_k.items()}
    nsteps = 2 + max(t_len - t_len // 4, 1)
    pres_k = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    pres_p = torch.zeros_like(pres_k)
    emit_k = _noise_emission(t_len, seed, cuda)
    emit_p = _noise_emission(t_len, seed + 1, cuda)
    _chunk_call(fc.fused_chunk, table, st_k, u, pres_k, nu, k, 2, nsteps,
                emit_k)
    _chunk_call(fc.fused_chunk_plain, table, st_p, u, pres_p, nu, k, 2,
                nsteps, emit_p)
    torch.cuda.synchronize()
    for name in st_k:
        assert torch.equal(st_k[name], st_p[name]), name
    assert torch.equal(pres_k, pres_p)
    assert torch.equal(emit_k[0], emit_p[0])
    assert torch.equal(emit_k[1], emit_p[1])
    if t_len > 4:
        assert not st_k['alive'].any()    # past the cap nobody is alive


def test_chunk_counters_count_card_launches_and_steps(cuda):
    table, st, u = _chunk_inputs(3, 1, torch.float32, 12, cuda)
    pres = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    fc.reset_launch_count()
    for t0, t1 in ((0, 5), (5, 12), (12, 12)):
        _chunk_call(fc.fused_chunk, table, st, u[t0:t1], pres, 1.0, 1, t0,
                    400, None)
    _chunk_call(fc.fused_chunk_plain, table, st, u, pres, 1.0, 1, 12, 400,
                None)
    assert fc.launch_count() == 2 and fc.steps_count() == 12


def test_chunk_wrapper_rejects_mixed_devices(cuda):
    table, st, u = _chunk_inputs(4, 1, torch.float32, 3, cuda)
    with pytest.raises(ValueError, match='on'):
        _chunk_call(fc.fused_chunk, table, st, u.cpu(),
                    torch.zeros(GRID, dtype=torch.int32, device=cuda), 1.0,
                    1, 0, 400, None)


def test_simulator_card_matches_cpu(cuda, tmp_path):
    """The small WY run on the card against the same run through the
    plain versions on the CPU, on one potential (the CPU run reads the
    card run's cached potential; see tests/test_torch_simulator.py on why
    the potential must be shared): smoothed maps within L1 0.08."""
    cfg = dict(run_name='wy_test', sim_mode='uniform', sim_seed=11,
               region_width_km=(12., 10.), resolution=200.,
               track_count=4096, track_start_region=(1., 11., 1., 2.),
               track_max_steps=400, potential_solver='direct',
               track_pkl_budget=0, mesh_devices=1, out_dir=str(tmp_path))
    maps = []
    for device in (cuda, 'cpu'):
        sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(**cfg),
                                       device=device)
        sim.simulate_tracks()
        counts = sim.get_presence_counts(sim.case_ids[0], 0)
        m = smooth_presence(torch.from_numpy(counts), 3).numpy()
        maps.append(m.astype(np.float64) / m.sum())
    assert np.abs(maps[0] - maps[1]).sum() < 0.08


def _hist_indices(rng, n, size):
    """Indices mostly inside [0, size), some negative, equal to size,
    or far beyond it."""
    idx = rng.integers(0, size, n)
    odd = rng.random(n)
    idx[odd < 0.05] = -1
    idx[(odd >= 0.05) & (odd < 0.1)] = -37
    idx[(odd >= 0.1) & (odd < 0.15)] = size
    idx[(odd >= 0.15) & (odd < 0.2)] = size + 200
    return idx


@pytest.mark.parametrize('grid', [(96, 130), (7, 5), (500, 600)])
@pytest.mark.parametrize('n', [0, 700, 100_000])
def test_weighted_histogram_matches_plain_on_card(cuda, grid, n):
    """Kernel B against its plain version on the card, with 0/1, small
    integer, quarter and bf16-rounded (257, 259) weights: exact."""
    nrow, ncol = grid
    rng = np.random.default_rng(n + nrow)
    r = torch.from_numpy(_hist_indices(rng, n, nrow).astype(np.int32))
    c = torch.from_numpy(_hist_indices(rng, n, ncol).astype(np.int32))
    for w in (rng.integers(0, 2, n), rng.integers(0, 6, n),
              rng.integers(0, 21, n) / 4.,
              rng.choice([0., 257., 259.], n)):
        w = torch.from_numpy(w.astype(np.float32))
        args = (r.to(cuda), c.to(cuda), w.to(cuda), nrow, ncol)
        got = ph.presence_histogram(*args)
        want = ph.presence_histogram_plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and tuple(got.shape) == grid
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), ph.presence_histogram(
            r, c, w, nrow, ncol))


def _plans(nrow, ncol, m):
    """The plan's own choice, and each count kernel forced."""
    plan = ph._count_plan(nrow, ncol, m,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    return {'plan': plan, 'direct': plan._replace(kernel='direct'),
            'privatized': plan._replace(kernel='privatized')}


@pytest.mark.parametrize('kernel', ['plan', 'direct', 'privatized'])
@pytest.mark.parametrize('dtype', [torch.int16, torch.int32])
@pytest.mark.parametrize('grid', [(96, 130), (7, 5), (500, 600)])
@pytest.mark.parametrize('n', [0, 700, 1_000_000, 7_500_000])
def test_count_histogram_matches_plain_on_card(cuda, grid, n, dtype,
                                               kernel):
    """Kernel C against its plain version on the card, with dead points
    (row -1, arbitrary columns): exact, for the plan's kernel and each
    kernel forced; the planes laid out as the recount lays them
    (16-byte aligned) and, for the privatized kernel, also not."""
    nrow, ncol = grid
    rng = np.random.default_rng(n + ncol)
    r = _hist_indices(rng, n, nrow)
    c = _hist_indices(rng, n, ncol)
    r[rng.random(n) < 0.3] = -1
    plan = _plans(nrow, ncol, n)[kernel]
    pts = torch.from_numpy(np.stack([r, c])).to(dtype).to(cuda)
    layouts = [(pts[0], pts[1])]
    if kernel != 'direct':
        odd = torch.from_numpy(np.stack([r, c])[:, 1:]).to(dtype).to(cuda)
        layouts += [(pts[0][1:].contiguous(), odd[1].contiguous()),
                    (odd[0], odd[1])]
    for rows, cols in layouts:
        got = ph.presence_histogram_batch(rows, cols, nrow, ncol, plan=plan)
        want = ph.presence_histogram_batch_plain(rows, cols, nrow, ncol)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and tuple(got.shape) == grid
        assert torch.equal(got, want)


@pytest.mark.parametrize('kernel', ['direct', 'privatized'])
@pytest.mark.parametrize('dtype', [torch.int16, torch.int32])
@pytest.mark.parametrize('case', ['hot_cell', 'bands'])
def test_count_histogram_hot_cell_and_bands_on_card(cuda, case, dtype,
                                                    kernel):
    """Kernel C, exact: 1M points in one cell (with 1000 elsewhere), and
    3M points on 1000x1000, which the privatized count covers in twenty
    bands."""
    rng = np.random.default_rng(5)
    if case == 'hot_cell':
        nrow, ncol, m = 500, 600, 1_001_000
        r = np.full(m, 321)
        c = np.full(m, 77)
        r[:1000] = rng.integers(-1, nrow, 1000)
        c[:1000] = rng.integers(0, ncol, 1000)
    else:
        nrow, ncol, m = 1000, 1000, 3_000_000
        r = _hist_indices(rng, m, nrow)
        c = _hist_indices(rng, m, ncol)
    plan = _plans(nrow, ncol, m)[kernel]
    assert plan.bands == (6 if case == 'hot_cell' else 20)
    pts = torch.from_numpy(np.stack([r, c])).to(dtype).to(cuda)
    got = ph.presence_histogram_batch(pts[0], pts[1], nrow, ncol, plan=plan)
    want = ph.presence_histogram_batch_plain(pts[0], pts[1], nrow, ncol)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize('pending', ['random', 'none', 'all', 'alive'])
@pytest.mark.parametrize('grid', [(7, 5), (500, 600)])
@pytest.mark.parametrize('n', [0, 700, 100_000])
def test_flush_matches_plain_on_card(cuda, grid, n, pending):
    """The flush kernel against its plain version on the card: the map
    (with counts already in it) exact, the flags returned cleared as a new
    tensor, and ``palive`` (here possibly ``alive`` itself) untouched."""
    nrow, ncol = grid
    rng = np.random.default_rng(n + nrow)
    r = torch.from_numpy(_hist_indices(rng, n, nrow).astype(np.int32))
    c = torch.from_numpy(_hist_indices(rng, n, ncol).astype(np.int32))
    flags = {'random': rng.random(n) < 0.6, 'none': np.zeros(n, bool),
             'all': np.ones(n, bool), 'alive': rng.random(n) < 0.9}[pending]
    palive = torch.from_numpy(flags).to(cuda)
    before = palive.clone()
    start = torch.from_numpy(rng.integers(0, 9, grid).astype(np.int32))
    maps = [start.to(cuda), start.to(cuda)]
    got = ph.presence_flush(r.to(cuda), c.to(cuda), palive, maps[0])
    want = ph.presence_flush_plain(r.to(cuda), c.to(cuda), palive, maps[1])
    torch.cuda.synchronize()
    assert torch.equal(maps[0], maps[1])
    assert got.dtype == torch.bool and got.shape == (n,) and not got.any()
    assert got.data_ptr() != palive.data_ptr() or n == 0
    assert torch.equal(palive, before) and torch.equal(want, got)


def test_flush_pending_is_one_flush_launch(cuda):
    """flush_pending on the card: one launch of the flush kernel and none
    of the weighted histogram, the map equal to the CPU's."""
    rng = np.random.default_rng(3)
    nrow, ncol = GRID
    params = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1.,
                              memory_k=1, burnin=2, nsteps=50)
    starts = np.stack([rng.integers(0, nrow, N), rng.integers(0, ncol, N)],
                      axis=1)
    valid = rng.random(N) < 0.7
    states = [tsim.init_state(params, starts, valid=valid, device=dev)
              for dev in (cuda, 'cpu')]
    ph.reset_launch_count()
    tsim.reset_flush_count()
    flushed = [tsim.flush_pending(st) for st in states]
    torch.cuda.synchronize()
    assert ph.launch_count('presence_flush') == tsim.flush_count() - 1 == 1
    assert ph.launch_count('presence_histogram') == 0
    assert torch.equal(flushed[0].presence.cpu(), flushed[1].presence)
    assert int(flushed[0].presence.sum()) == int(valid.sum())
    assert not flushed[0].palive.any()
    assert torch.equal(flushed[0].alive.cpu(), torch.from_numpy(valid))


def test_histogram_launch_counters_count_card_launches(cuda):
    r = torch.arange(10, dtype=torch.int32, device=cuda)
    ph.reset_launch_count()
    for _ in range(2):
        ph.presence_histogram(r, r, torch.ones(10, device=cuda), 16, 16)
    ph.presence_histogram_batch(r, r, 16, 16)
    ph.presence_histogram_batch(r.to(torch.int16), r.to(torch.int16), 16,
                                16)
    ph.presence_histogram_batch(r, r, 16, 16, plan=_plans(
        16, 16, 10)['privatized'])
    presence = torch.zeros((16, 16), dtype=torch.int32, device=cuda)
    flags = torch.ones(10, dtype=torch.bool, device=cuda)
    ph.presence_flush(r, r, flags, presence)
    ph.presence_histogram_plain(r, r, torch.ones(10, device=cuda), 16, 16)
    ph.presence_histogram_batch_plain(r, r, 16, 16)
    ph.presence_flush_plain(r, r, flags, presence)
    assert ph.launch_count('presence_histogram') == 2
    assert ph.launch_count('presence_histogram_batch') == 3
    assert ph.launch_count('presence_flush') == 1


def test_recorded_run_on_card_counts_equal_recount(cuda, tmp_path):
    """A small recorded run (the default budget) on the card: the counts
    equal the recount of its ``_tracks.pkl``; the chunk kernel ran once a
    chunk (2000 agents x 512 steps is one uniform block) and covered every
    step, the per-step kernel never, the flush kernel every flush, the
    weighted histogram never, and kernel C the recount."""
    cfg = dict(run_name='wy_rec', sim_mode='uniform', sim_seed=11,
               region_width_km=(12., 10.), resolution=200.,
               track_count=2000, track_start_region=(1., 11., 1., 2.),
               track_max_steps=400, potential_solver='direct',
               mesh_devices=1, out_dir=str(tmp_path))
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(**cfg),
                                   device=cuda)
    fs.reset_launch_count()
    fc.reset_launch_count()
    ph.reset_launch_count()
    tsim.reset_flush_count()
    sim.simulate_tracks()
    rec = {r['phase']: r for r in sim.timer.records}['tracks']
    assert rec['recorded'] and fs.launch_count() == 0
    assert fc.steps_count() == rec['steps']
    assert fc.launch_count() == -(-rec['steps'] // 512)
    assert ph.launch_count('presence_flush') == tsim.flush_count() >= 1
    assert ph.launch_count('presence_histogram') == 0
    counts_path = os.path.join(
        sim.mode_data_dir, 's10d270_d0_t75_fluidflow_r0_counts.npy')
    counts = np.load(counts_path)
    os.remove(counts_path)
    recount = sim.get_presence_counts(sim.case_ids[0], 0)
    assert ph.launch_count('presence_histogram_batch') == 1
    assert recount.dtype == np.int16
    np.testing.assert_array_equal(recount.astype(np.int32), counts)


@pytest.mark.parametrize('field,dirn,bound', [
    ('hard', 0., 1e-2), ('hard', 45., 1e-2), ('hard', 90., 1e-2),
    ('fuzz', 45., 1.0), ('fuzz', 135., 1.0), ('hard460', 0., 1.0)])
def test_refined_solve_on_card_matches_cpu(cuda, field, dirn, bound):
    """The refined solver on the card and through the same code on the
    CPU: both within the JAX package's bound of the direct solve
    (tests/test_potential.py), so within twice that of each other."""
    from ssrs_tpu_torch.potential import (boundary_masks,
                                          solve_potential_direct,
                                          solve_potential_refined)
    cond = {'hard': lambda: conductivity_hard((24, 30), 1),
            'fuzz': lambda: speckle(
                np.random.default_rng(int(dirn)), (64, 64), 0.5),
            'hard460': lambda: conductivity_hard((460, 460), 1)}[field]()
    bmask, bvals = boundary_masks(dirn, cond.shape)
    want = solve_potential_direct(cond, dirn).astype(np.float64)
    pots = []
    for dev in (cuda, torch.device('cpu')):
        pot, rrel = solve_potential_refined(torch.from_numpy(cond).to(dev),
                                            bmask, bvals)
        assert pot.device.type == dev.type and pot.dtype == torch.float32
        pot = pot.cpu().numpy().astype(np.float64)
        assert np.abs(pot - want).max() < bound and rrel < 1e-5
        pots.append(pot)
    assert np.abs(pots[0] - pots[1]).max() < 2 * bound


def test_refined_solve_on_card_is_bitwise_repeatable(cuda):
    from ssrs_tpu_torch.potential import (boundary_masks,
                                          solve_potential_refined)
    cond = torch.from_numpy(speckle(
        np.random.default_rng(3), (200, 240), 0.55)).to(cuda)
    bmask, bvals = boundary_masks(0., tuple(cond.shape))
    a, ra = solve_potential_refined(cond, bmask, bvals)
    b, rb = solve_potential_refined(cond.clone(), bmask, bvals)
    assert torch.equal(a, b) and ra == rb


def test_vcycle_on_card_reads_nothing_back(cuda):
    """A V-cycle enqueues its work without a device-to-host sync: the
    only syncs of a solve are the GCR exit tests and the refinement
    passes' residual reads."""
    from ssrs_tpu_torch.potential import boundary_masks
    from ssrs_tpu_torch.potential import lap
    cond = speckle(np.random.default_rng(5), (120, 150), 0.55)
    bmask, _ = boundary_masks(0., cond.shape)
    labels, k = lap.island_labels(cond, bmask)
    assert k > 0
    planes = lap.symmetrize_planes(
        lap.weight_planes(torch.from_numpy(cond).to(cuda)))
    levels = lap.build_lap_levels(planes, torch.from_numpy(bmask).to(cuda),
                                  labels, k + 1)
    rhs = torch.rand(cond.shape, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = lap.vcycle(levels, rhs, torch.zeros_like(rhs))
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert torch.isfinite(out).all()


@pytest.mark.parametrize('k', [0, 1, 3])
@pytest.mark.parametrize('nu', [1.0, 0.0])
def test_kernels_without_a_table_match_plain_on_card(cuda, k, nu):
    """The directed random walk: a null table pointer in the per-step and
    in the chunk kernel, each exactly equal to its plain version (state,
    presence, emission rows)."""
    _, a = _inputs(60 + k, k, torch.float32, cuda)
    pk = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    pp = torch.zeros_like(pk)
    out_k = _call(fs.fused_step, None, a, pk, nu, k)
    out_p = _call(fs.fused_step_plain, None, a, pp, nu, k)
    torch.cuda.synchronize()
    for x, y in zip(out_k + (pk,), out_p + (pp,)):
        assert torch.equal(x, y)
    t_len = 64
    _, st_k, u = _chunk_inputs(70 + k, k, torch.float32, t_len, cuda)
    st_p = {name: v.clone() for name, v in st_k.items()}
    pres_k = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    pres_p = torch.zeros_like(pres_k)
    emit_k = _noise_emission(t_len, k, cuda)
    emit_p = _noise_emission(t_len, k + 1, cuda)
    _chunk_call(fc.fused_chunk, None, st_k, u, pres_k, nu, k, 2, 50, emit_k)
    _chunk_call(fc.fused_chunk_plain, None, st_p, u, pres_p, nu, k, 2, 50,
                emit_p)
    torch.cuda.synchronize()
    for name in st_k:
        assert torch.equal(st_k[name], st_p[name]), name
    assert torch.equal(pres_k, pres_p) and int(pres_k.sum()) > 0
    assert torch.equal(emit_k[0], emit_p[0])
    assert torch.equal(emit_k[1], emit_p[1])


def test_kernels_without_a_table_nu2_on_card(cuda):
    """nu = 2: expf/logf against torch's exp/log may round apart on a rare
    draw; >= 99.9% of moves equal, the presence exact."""
    _, a = _inputs(80, 1, torch.float32, cuda)
    pk = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    pp = torch.zeros_like(pk)
    out_k = _call(fs.fused_step, None, a, pk, 2.0, 1)
    out_p = _call(fs.fused_step_plain, None, a, pp, 2.0, 1)
    torch.cuda.synchronize()
    same = (out_k[0] == out_p[0]) & (out_k[1] == out_p[1])
    assert float(same.to(torch.float64).mean()) >= 0.999
    assert torch.equal(pk, pp)


def test_cases_driver_on_card_bit_identical_to_single(cuda):
    """``simulate_presence_cases_compacting`` on the card: every case (two
    tables, one walk without a table) equals the single-case driver with
    the same seed, and the card ran one chunk launch a chunk and one flush
    launch a flush."""
    rng = np.random.default_rng(11)
    nrow, ncol = GRID
    params = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1.,
                              memory_k=1, burnin=4, nsteps=300)
    dirp = torch.from_numpy(directional_probs(0.)).to(cuda)
    pot = torch.linspace(1000., 0., nrow, device=cuda)[:, None].expand(
        nrow, ncol).contiguous()
    tables = [tsim.prepared_weights(
        torch.from_numpy(rng.random(GRID).astype(np.float32) + 0.5).to(cuda),
        pot, dirp, 'float32') for _ in range(2)] + [None]
    starts = np.stack([rng.integers(3, 6, 5000),
                       rng.integers(5, ncol - 5, 5000)], axis=1)

    def gens():
        return [torch.Generator(device=cuda).manual_seed(40 + i)
                for i in range(3)]

    fs.reset_launch_count()
    fc.reset_launch_count()
    ph.reset_launch_count()
    tsim.reset_flush_count()
    presence, steps = tsim.simulate_presence_cases_compacting(
        params, tables, starts, gens(), chunk=64, min_bucket=256)
    torch.cuda.synchronize()
    assert fs.launch_count() == 0
    assert fc.launch_count() == sum(-(-int(s) // 64) for s in steps)
    assert ph.launch_count('presence_flush') == tsim.flush_count() >= 3
    for i, gen in enumerate(gens()):
        want, want_steps = tsim.simulate_presence_compacting(
            params, starts, gen, base_flat=tables[i], chunk=64,
            min_bucket=256)
        assert torch.equal(presence[i], want) and steps[i] == want_steps
        assert int(want.sum()) >= 5000 * (params.burnin + 1)


def test_gaussian_filter_on_card_matches_cpu(cuda):
    """Two float32 convolutions of 33 taps, TF32 off: 1e-5 of the field's
    maximum between card and CPU."""
    from ssrs_tpu_torch.fields import gaussian_filter
    rng = np.random.default_rng(13)
    field = torch.from_numpy((rng.random((500, 600)) ** 8 * 40.)
                             .astype(np.float32))
    got = gaussian_filter(field.to(cuda)).cpu()
    want = gaussian_filter(field)
    assert float((got - want).abs().max()) <= 1e-5 * float(field.max())


def test_sweep_on_card_fields_device_bitwise(cuda, tmp_path):
    """A small direction sweep on the card, with device-resident fields
    and through numpy: bitwise-equal counts and potentials."""
    arts = []
    for fields_device in (True, False):
        cfg = dict(run_name=f'sweep_{fields_device}', sim_mode='uniform',
                   sim_seed=5, region_width_km=(12., 10.), resolution=200.,
                   track_count=4096, track_start_region=(1., 11., 1., 2.),
                   track_max_steps=400, fields_device=fields_device,
                   out_dir=str(tmp_path))
        sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(**cfg),
                                       device=cuda)
        cases = sim.simulate_direction_sweep([0., 270.])
        arts.append([np.load(os.path.join(
            sim.mode_data_dir, f'{c}_d0_t75_fluidflow_r0_{kind}.npy'))
            for c in cases for kind in ('counts', 'potential')])
    for a, b in zip(*arts):
        np.testing.assert_array_equal(a, b)
