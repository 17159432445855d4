"""The refined solver's GCR history as fixed slots, on the CPU.

``potential/lap.py`` keeps the last ``_GCR_K`` GCR directions in fixed
slots, oldest first, whose empty ones hold exact zeros, so that a CUDA
graph can replay an iteration on buffers that never move. Here:

- whole solves through the fixed slots against a copy of the loop that
  kept the history in a ``deque`` (the solver before the slots): equal
  potentials (``torch.equal``, so the sign of a zero does not count),
  ``rrel``, passes and V-cycles, on a hard field, a field with
  east-strip islands and a batch of three with a stalled case;
- the buffers' in-place update (``_write_state``, what a graph replay
  copies back) against the eager iteration's new state;
- CPU tensors and row blocks take the eager loop: no ``potential.capture``
  span and no ``graph_replays``;
- the benchmark's ``graph_share.run`` reader on synthetic jobs.
"""

import importlib.util
import os
import types
from collections import deque

import numpy as np
import pytest
import torch

from ssrs_tpu_torch.core.timing import PhaseTimer
from ssrs_tpu_torch.parallel import fields as pf
from ssrs_tpu_torch.potential import (boundary_masks, solve_potential_refined,
                                      solve_potential_refined_batch)
from ssrs_tpu_torch.potential import lap
from ssrs_tpu_torch.potential.fields import conductivity_hard, speckle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """A solve is thousands of small ops, which crawl on a thread pool
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deque_gcr_solve(levels, rhs, maxiter, tol_abs, active=None,
                     graph=None, depth=lap._GCR_K):
    """The GCR loop with its history in a ``deque``, as the solver ran
    before the fixed slots (same signature as ``lap._gcr_solve``)."""
    assert graph is None
    top = levels[0]
    notb = top.notb
    dinv2 = top.dinv * top.dinv

    def sdot(a, b):
        return lap._total((a * dinv2) * b)

    def snorm(r):
        return lap._norm(r * top.dinv)

    x = lap._each(torch.zeros_like, rhs)
    hist = deque(maxlen=depth)
    rn = rn_prev = snorm(rhs)
    its = np.zeros(rn.numel(), np.int64)
    it = 0

    def exit_test():
        go = rn > tol_abs
        if it >= 8:
            go = go & (rn < 0.995 * rn_prev)
        if active is not None:
            go = go & active
        return go, lap._host(go)

    stop = np.zeros(rn.numel(), bool)
    go, going = exit_test() if maxiter > 0 else (None, stop)
    while going.any():
        its += going
        r = (rhs - lap._apply_lap(top.planes, x)) * notb
        z = lap.vcycle(levels, r, lap._each(torch.zeros_like, x)) * notb
        q = lap._apply_lap(top.planes, z) * notb
        for zi, qi in hist:
            beta = sdot(q, qi)
            z = z - beta * zi
            q = q - beta * qi
        nrm2 = sdot(q, q)
        inv = torch.where(nrm2 > 0, torch.rsqrt(nrm2 + 1e-38), 0.)
        z, q = z * inv, q * inv
        alpha = sdot(r, q)
        x = lap._keep(go, x + alpha * z, x)
        hist.append((z, q))
        rn_new = snorm((rhs - lap._apply_lap(top.planes, x)) * notb)
        rn_prev, rn = lap._keep(go, rn, rn_prev), lap._keep(go, rn_new, rn)
        if lap._is_batch(x):
            active = go
        it += 1
        go, going = exit_test() if it < maxiter else (go, stop)
    return x, rn, its


def _strip_field():
    """A hard field whose two easternmost columns hold islands (the
    east-column fac quirk: those islands are left to the per-level
    deflation and the GCR)."""
    cond = conductivity_hard((60, 80), seed=7)
    cond[:, -6:] = 0.0
    cond[12:24, -3:] = 2.0
    cond[40:52, -2:] = 1.5
    return cond


def _single(cond, dirn):
    def solve():
        bmask, bvals = boundary_masks(dirn, cond.shape)
        stats = {}
        pot, rrel = solve_potential_refined(torch.from_numpy(cond), bmask,
                                            bvals, stats=stats)
        return pot, [rrel], [stats['passes']], [stats['vcycles']]
    return solve


def _batch():
    bad = speckle(np.random.default_rng(225), (64, 64), 0.5)
    conds = np.stack([bad, conductivity_hard((64, 64), seed=1),
                      conductivity_hard((64, 64), seed=4)])

    def solve():
        bmask, bvals = boundary_masks(225., (64, 64))
        stats = {}
        pots, rrels = solve_potential_refined_batch(
            torch.from_numpy(conds), bmask, bvals, stats=stats)
        return pots, list(rrels), stats['passes'], stats['vcycles']
    return solve


CASES = {'hard': _single(conductivity_hard((60, 72), 1), 0.),
         'east_strip': _single(_strip_field(), 0.),
         'batch_stalled': _batch()}


@pytest.mark.parametrize('case', sorted(CASES))
def test_fixed_slots_solve_as_the_deque(case, monkeypatch):
    solve = CASES[case]
    pot, rrel, passes, cycles = solve()
    with monkeypatch.context() as mp:
        mp.setattr(lap, '_gcr_solve', _deque_gcr_solve)
        want, want_rrel, want_passes, want_cycles = solve()
    assert torch.equal(pot, want)
    assert rrel == want_rrel
    assert passes == want_passes and cycles == want_cycles
    if case == 'batch_stalled':
        # the speckle field stalls above the net; the others converge
        assert rrel[0] > 5e-3 and max(rrel[1:]) < 1e-5
        assert len(set(cycles)) > 1


def _levels(conds, dirn=0.):
    bmask, _ = boundary_masks(dirn, conds.shape[-2:])
    if conds.ndim == 3:
        labels, k = lap.batch_island_labels(conds > 0, bmask)
    else:
        labels, k = lap.island_labels(conds, bmask)
    planes = lap.symmetrize_planes(lap.weight_planes(torch.from_numpy(conds)))
    return lap.build_lap_levels(planes, torch.from_numpy(bmask), labels,
                                k + 1)


@pytest.mark.parametrize('batch', [False, True])
def test_buffers_written_in_place_follow_the_eager_state(batch):
    """What a replay does to its buffers: the new state computed from the
    buffers, copied into them in order (``_write_state``), equals the
    eager iteration's new state, iteration after iteration, past the
    filling of the history; on a batch a case stops on the way."""
    rng = np.random.default_rng(5)
    cond = speckle(rng, (40, 48), 0.5)
    conds = np.stack([cond, conductivity_hard((40, 48), 3)]) if batch \
        else cond
    levels = _levels(conds)
    rhs = torch.from_numpy(rng.standard_normal(conds.shape).astype(
        np.float32)) * levels[0].notb
    active = torch.ones(2, 1, 1, dtype=torch.bool) if batch else None
    eager = lap._gcr_start(levels, rhs, active)
    bufs = lap._gcr_start(levels, rhs.clone(),
                          None if active is None else active.clone())
    fields = bufs.fields()
    for it in range(lap._GCR_K + 3):
        go = eager.active & torch.tensor([True, it < 2]).view(2, 1, 1) \
            if batch else None
        eager = lap._gcr_iteration(levels, rhs, eager, go)
        lap._write_state(bufs, lap._gcr_iteration(levels, rhs, bufs, go))
        assert all(a is b for a, b in zip(bufs.fields(), fields))
        for a, b in zip(bufs.fields(), eager.fields()):
            assert torch.equal(a, b), it
    if batch:
        assert eager.active.view(-1).tolist() == [True, False]


def test_empty_slots_hold_zeros_and_shift_oldest_first():
    levels = _levels(conductivity_hard((24, 30), 1))
    rhs = torch.ones(24, 30) * levels[0].notb
    s = lap._gcr_start(levels, rhs)
    assert len(s.zs) == len(s.qs) == lap._GCR_K
    assert all(not z.any() for z in s.zs + s.qs)
    assert len({id(t) for t in s.fields()}) == len(s.fields())
    assert torch.equal(s.rn, s.rn_prev) and s.rn is not s.rn_prev
    one = lap._gcr_iteration(levels, rhs, s, None)
    two = lap._gcr_iteration(levels, rhs, one, None)
    assert all(not z.any() for z in two.zs[:-2])
    assert two.zs[-2] is one.zs[-1] and two.qs[-2] is one.qs[-1]
    assert torch.equal(two.rn_prev, one.rn)


def _solve_spans(solve, outer):
    timer = PhaseTimer()
    with timer.span(outer):
        solve()
    return timer.records


@pytest.mark.parametrize('kind', ['cpu', 'row_blocks'])
def test_cpu_and_row_blocks_take_the_eager_loop(kind):
    cond = conductivity_hard((48, 56), 1)
    bmask, bvals = boundary_masks(0., cond.shape)
    if kind == 'cpu':
        assert not lap._takes_graph(torch.from_numpy(cond))
        recs = _solve_spans(lambda: solve_potential_refined(
            torch.from_numpy(cond), bmask, bvals), 'job')
    else:
        blocks = pf.RowBlocks.split(bvals, [0, 24, 48], ['cpu'] * 2,
                                    pf.Transfers(), dtype=torch.float32)
        assert not lap._takes_graph(blocks)
        # the sharded solve opens no span of its own: its counters go to
        # the innermost open span named potential.solve
        recs = _solve_spans(lambda: pf.solve_potential_refined_sharded(
            cond, bmask, bvals, mesh=['cpu'] * 2), 'potential.solve')
    names = [r['phase'] for r in recs]
    assert 'potential.capture' not in names and 'potential.pass' in names
    solve, = [r for r in recs if r['phase'] == 'potential.solve']
    assert solve['iterations'] > 0
    assert solve.get('graph_replays', 0) == 0


def _reader(name):
    path = os.path.join(REPO, 'benchmark', 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location('graph_share_run', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _job(*solves):
    return types.SimpleNamespace(records=[
        {'phase': 'potential.solve', 'seconds': 1., **c} for c in solves])


@pytest.mark.parametrize('jobs,want', [
    ([_job(dict(iterations=60, graph_replays=60)),
      _job(dict(iterations=40, graph_replays=40))], 1.0),
    ([_job(dict(iterations=60, graph_replays=60)),
      _job(dict(iterations=40))], 0.6),
    ([_job(dict(iterations=50, graph_replays=50), dict(iterations=50))],
     0.5),
    ([_job(dict(iterations=60)), _job(dict(iterations=40))], None),
    ([_job(dict(graph_replays=0, iterations=0))], None),
    ([], None)])
def test_graph_share_reader(jobs, want):
    got = _reader('graph_share.run')(types.SimpleNamespace(jobs=jobs))
    assert got == (None if want is None else pytest.approx(want))
