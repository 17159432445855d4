"""The readers of the program's spans and counters on synthetic jobs and
trace dicts: each reads its number, and gives None, never 0, where the
program has no such span or counter (as a program before the spans).
Then both cells traced on the CPU at the tiny cut report them."""

import types

import pytest

from benchmark import cells, harness
from conftest import REPO

RUN = ('levels_s.run', 'iteration_ms.run', 'solve_wait_s.run',
       'launches_per_vcycle.run')
ENSEMBLE = ('reproject_s.ensemble', 'saves_s.ensemble',
            'alive_wait_s.ensemble', 'unspanned_s.ensemble')


def _rec(name, seconds, span, parent=None, t0=0., **counters):
    return {'phase': name, 'seconds': seconds, 'span': span,
            'parent': parent, 't0_ns': int(t0 * 1e9), **counters}


def _job(records, wall=1.):
    return types.SimpleNamespace(records=records, wall=wall)


def _ctx(jobs, trace=None):
    return types.SimpleNamespace(jobs=jobs, trace=trace)


def _reader(name):
    return cells.metric_reader(REPO, name)


def _run_job():
    """A run job: a solve of 2 passes (3 + 2 iterations) and its set-up."""
    return _job([
        _rec('potential.labels', 0.02, 2, 1, 1.0),
        _rec('potential.levels', 0.03, 3, 1, 1.02),
        _rec('potential.iteration', 0.030, 5, 4, 1.1),
        _rec('potential.iteration', 0.032, 6, 4, 1.13),
        _rec('potential.iteration', 0.034, 7, 4, 1.17),
        _rec('potential.pass', 0.1, 4, 1, 1.1),
        _rec('potential.iteration', 0.036, 9, 8, 1.2),
        _rec('potential.iteration', 0.038, 10, 8, 1.24),
        _rec('potential.pass', 0.08, 8, 1, 1.2),
        _rec('potential.solve', 0.3, 1, 0, 1.0, iterations=5,
             read_wait_s=0.004),
        {'phase': 'potential', 'seconds': 0.31, 'vcycles': 5},
        _rec('simulate_tracks', 0.5, 0, None, 0.9)], wall=2.)


def _ensemble_job(t=0., wall=0.3):
    return _job([
        _rec('terrain', 0.003, 1, 0, t),
        _rec('terrain.reproject', 0.06, 3, 2, t + 0.01),
        _rec('save.orographs', 0.002, 4, 2, t + 0.08),
        _rec('updrafts', 0.1, 2, 0, t + 0.005),
        _rec('save.config', 0.001, 5, 0, t + 0.11),
        _rec('init', 0.12, 0, None, t),
        _rec('batched_tracks', 0.03, 7, 6, t + 0.15, alive_wait_s=0.01),
        _rec('save.counts', 0.004, 8, 6, t + 0.18),
        _rec('direction_sweep', 0.08, 6, None, t + 0.125),
        _rec('save.phase_log', 0.001, 9, None, t + 0.21),
        _rec('presence_map', 0.03, 10, None, t + 0.215),
        _rec('save.summary', 0.002, 11, 10, t + 0.24)],
        wall=wall)


def test_run_readers():
    jobs = [_run_job(), _run_job()]
    ctx = _ctx(jobs, trace={'launches': 14100, 'job': _run_job()})
    assert _reader('levels_s.run')(ctx) == pytest.approx(0.05)
    assert _reader('iteration_ms.run')(ctx) == pytest.approx(34.)
    assert _reader('solve_wait_s.run')(ctx) == pytest.approx(0.004)
    assert _reader('launches_per_vcycle.run')(ctx) == pytest.approx(2820.)


def test_ensemble_readers():
    jobs = [_ensemble_job(), _ensemble_job(5., 0.4)]
    ctx = _ctx(jobs)
    assert _reader('reproject_s.ensemble')(ctx) == pytest.approx(0.06)
    # every save.* span, nested or top-level
    assert _reader('saves_s.ensemble')(ctx) == pytest.approx(0.010)
    assert _reader('alive_wait_s.ensemble')(ctx) == pytest.approx(0.01)
    # top level: init [0, .12], the sweep [.125, .205], the log
    # [.21, .211], the map [.215, .245]: 0.231 s of a 0.3 and a 0.4 s job
    assert _reader('unspanned_s.ensemble')(ctx) == pytest.approx(
        (0.3 + 0.4) / 2 - 0.231)


def test_unspanned_counts_overlap_once():
    job = _job([_rec('a', 0.2, 0, None, 1.0), _rec('b', 0.2, 1, None, 1.1),
                _rec('c', 0.05, 2, None, 1.15), _rec('d', 5., 3, 0, 0.)],
               wall=1.)
    assert _reader('unspanned_s.ensemble')(_ctx([job])) == \
        pytest.approx(0.7)


def _old_job():
    """A job of a program before the spans: phase records alone."""
    return _job([{'phase': 'terrain', 'seconds': 0.003},
                 {'phase': 'updrafts', 'seconds': 0.1},
                 {'phase': 'potential', 'seconds': 3., 'vcycles': 100,
                  'passes': 5},
                 {'phase': 'batched_tracks', 'seconds': 0.03, 'cases': 8},
                 {'phase': 'simulate_tracks', 'seconds': 3.4},
                 {'phase': 'presence_map', 'seconds': 0.03}])


@pytest.mark.parametrize('name', RUN + ENSEMBLE)
def test_missing_spans_give_none(name):
    read = _reader(name)
    trace = {'launches': 280000, 'job': _old_job()}
    assert read(_ctx([_old_job(), _old_job()], trace)) is None
    assert read(_ctx([], trace)) is None


def test_launches_need_a_trace_with_launches():
    read = _reader('launches_per_vcycle.run')
    assert read(_ctx([_run_job()])) is None
    assert read(_ctx([_run_job()], {'launches': 0, 'job': _run_job()})) \
        is None
    job = _run_job()
    job.records = [r for r in job.records if r['phase'] != 'potential.solve']
    assert read(_ctx([job], {'launches': 100, 'job': job})) is None


def test_spec_lists_the_readers():
    spec = cells.load_spec(REPO)
    by = {m['name']: m for m in spec['per_layer']}
    for names, cell in ((RUN, 'wy_uniform.run'),
                        (ENSEMBLE, 'wy_sweep.ensemble')):
        for name in names:
            assert by[name]['workloads'] == [cell]
            assert name in {m['name'] for m in
                            cells.cell_metrics(spec, cell, True)}


@pytest.mark.parametrize('cell,names', [('wy_uniform.run', RUN),
                                        ('wy_sweep.ensemble', ENSEMBLE)])
def test_traced_cells_report_them(tiny_root, cell, names, one_thread):
    res = harness.run_cell(tiny_root, cell, 2 ** 31 + 23, 0.5, True, 'cpu')
    assert res['correct'] is True, res['checks']
    got = set(res['metrics'])
    # the CPU launches no kernel: launches_per_vcycle reads nothing there
    want = set(names) - {'launches_per_vcycle.run'}
    assert want <= got, want - got
    for name in want:
        assert res['metrics'][name]['value'] >= 0., name
