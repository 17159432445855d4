"""The port's spans and counters (``ssrs_tpu_torch/core/timing.py``).

- a nested tree of phases and spans: numbers, parent links, record order;
- ``count`` on the innermost open span (or the one named), ``read_host``;
- nothing recorded, and no profiler range opened, with no timer open or
  no profiler on;
- the ranges ``phase:<name>`` under ``torch.profiler`` (CPU activity),
  their start within 10 ms of the records' ``t0_ns``;
- the phase log's dumps: one JSON list equal to the records, appended,
  so that their bytes grow with the records added, not with the log,
  and written anew where the file was deleted or written by another
  timer since;
- a small uniform run and a direction sweep of the ``Simulator`` on the
  CPU: the span tree of the solve, its ``iterations`` against the
  ``potential`` record's ``vcycles``, and every record that existed
  before the spans with its name and fields.
"""

import inspect
import json
import os

import pytest
import requests
import torch

import ssrs_tpu_torch
from ssrs_tpu_torch.core import timing
from ssrs_tpu_torch.core.timing import PhaseTimer, count, read_host, span
from ssrs_tpu_torch.potential import lap
from ssrs_tpu_torch.potential.boundary import boundary_masks

NEW_FIELDS = {'span', 'parent', 't0_ns'}
CONFIG = dict(
    sim_mode='uniform', sim_seed=11, southwest_lonlat=(-106.21, 42.78),
    region_width_km=(12., 10.), resolution=200., uniform_winddirn=270.,
    uniform_windspeed=10., track_direction=0., track_count=4096,
    track_start_region=(1., 11., 1., 2.), track_start_type='random',
    track_max_steps=400, movement_model='fluidflow',
    potential_solver='auto', track_pkl_budget=0, mesh_devices=1)


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


def _tree():
    """A timer after a phase ``a`` holding spans ``b`` (holding ``c``) and
    ``d``, with counters."""
    timer = PhaseTimer()
    with timer.phase('a', tag=1):
        with span('b'):
            count('n')
            with span('c', k=2):
                count('n', 5)
                count('m', 0.5, on='b')
        with span('d'):
            pass
        count('n', 3)
    return timer


def test_tree_numbers_parents_and_order():
    recs = _tree().records
    # a span's record follows its children's
    assert [r['phase'] for r in recs] == ['c', 'b', 'd', 'a']
    by = {r['phase']: r for r in recs}
    assert [by[n]['span'] for n in 'abcd'] == [0, 1, 2, 3]
    assert by['a']['parent'] is None
    assert by['b']['parent'] == by['d']['parent'] == 0
    assert by['c']['parent'] == 1
    assert by['a']['tag'] == 1 and by['c']['k'] == 2
    assert list(by['a'])[:3] == ['phase', 'seconds', 'tag']
    assert by['a']['seconds'] >= by['b']['seconds'] >= by['c']['seconds']
    assert by['a']['t0_ns'] <= by['b']['t0_ns'] <= by['c']['t0_ns'] \
        <= by['d']['t0_ns']


def test_count_lands_on_innermost_span():
    by = {r['phase']: r for r in _tree().records}
    assert by['c']['n'] == 5 and by['b']['n'] == 1 and by['a']['n'] == 3
    assert by['b']['m'] == 0.5 and 'm' not in by['c']
    assert 'n' not in by['d']


def test_count_on_a_name_not_open_does_nothing():
    timer = PhaseTimer()
    with timer.span('a'):
        count('n', on='zzz')
        timer.count('n', on='zzz')
    assert timer.records == [{'phase': 'a', 'seconds': timer.records[0][
        'seconds'], 'span': 0, 'parent': None,
        't0_ns': timer.records[0]['t0_ns']}]


def test_read_host_counts_the_read_and_its_wait():
    timer = PhaseTimer()
    x = torch.arange(4)
    with timer.span('a'):
        with span('b'):
            for _ in range(3):
                out = read_host(x, 'wait', on='a')
    assert torch.equal(out, x)
    rec = timer.records[-1]
    assert rec['phase'] == 'a' and rec['wait'] >= 0.
    assert 'wait' not in timer.records[0]


def test_nothing_recorded_without_a_timer():
    assert timing._OPEN.get() is None
    with span('x', a=1) as rec:
        count('n')
        assert rec is None
    assert torch.equal(read_host(torch.ones(2), 'w'), torch.ones(2))
    # a library solve outside any timer records nothing and leaves none
    cond = torch.ones(12, 14)
    cond[4:7, 5:9] = 0.
    bmask, bvals = boundary_masks(0., (12, 14))
    pot, rrel = lap.solve_potential_refined(cond, bmask, bvals)
    assert torch.isfinite(pot).all() and rrel < 1e-3
    assert timing._OPEN.get() is None


def test_timer_closes_its_span_on_an_exception():
    timer = PhaseTimer()
    with pytest.raises(KeyError):
        with timer.phase('a'):
            with span('b'):
                raise KeyError('x')
    # no record of a span that raised, and nothing left open
    assert timer.records == [] and timer._open == []
    assert timing._OPEN.get() is None
    with timer.span('c'):
        pass
    assert timer.records[0]['parent'] is None


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: opened.append(name))
    _tree()
    assert opened == []


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith('phase:'):
            ranges.setdefault(ev.name()[6:], []).append(ev.start_ns())
    return out, ranges


def test_ranges_under_the_profiler():
    timer, ranges = _profiled(_tree)
    assert sorted(ranges) == ['a', 'b', 'c', 'd']
    assert all(len(v) == 1 for v in ranges.values())
    # outside the profiler again: no range, the same records
    assert [r['phase'] for r in _tree().records] == \
        [r['phase'] for r in timer.records]


def test_t0_ns_on_the_profilers_clock():
    timer, ranges = _profiled(_tree)
    for rec in timer.records:
        assert abs(rec['t0_ns'] - ranges[rec['phase']][0]) < 10_000_000, rec


def _load(path):
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def test_dump_is_one_list_equal_to_the_records(tmp_path):
    path = str(tmp_path / 'log.json')
    with open(path, 'w') as f:
        f.write('stale content of another run ' * 100)
    timer = PhaseTimer()
    timer.dump(path)
    # a dump's last record is its own
    assert _load(path) == timer.records
    assert [r['phase'] for r in timer.records] == ['save.phase_log']
    with timer.phase('a', x=[1, 2]):
        pass
    timer.dump(path)
    assert _load(path) == timer.records
    timer.dump(path)
    for i in range(3):
        with timer.span('b', i=i):
            count('n', i)
    timer.dump(path)
    assert _load(path) == timer.records
    assert [r['phase'] for r in timer.records] == [
        'save.phase_log', 'a', 'save.phase_log', 'save.phase_log',
        'b', 'b', 'b', 'save.phase_log']
    assert [r['span'] for r in timer.records] == [0, 1, 2, 3, 4, 5, 6, 7]
    # another timer's first dump writes the file anew
    other = PhaseTimer()
    with other.span('z'):
        pass
    other.dump(path)
    assert _load(path) == other.records


def test_dump_bytes_grow_with_the_records_added(tmp_path):
    """300 dumps of a growing log, one to four records a dump: each
    dump's bytes are those of the records it adds (and a separator and
    bracket), so they do not grow with the log's length."""
    path = str(tmp_path / 'phase_timings.json')
    timer = PhaseTimer()
    written, added = [], []
    for i in range(300):
        n = 1 + i % 4
        for j in range(n):
            with timer.span('save.counts', id=f'case{j:03d}'):
                count('n', 1000 + j)
        written.append(timer.dump(path))
        added.append(n)
    one = len(json.dumps(timer.records[0])) + 2
    # the records added and the dump's own
    for w, n in zip(written, added):
        assert w <= (n + 1) * (one + 16), (w, n)
    # the last dumps cost what the first ones did
    assert sum(written[-40:]) <= 1.1 * sum(written[:40]) + 40 * 16
    assert os.path.getsize(path) <= sum(written)
    assert _load(path) == timer.records


def test_dump_rewrites_a_file_deleted_or_replaced(tmp_path):
    """A dump appends only to the file the timer's last dump left: after
    the file is deleted, or another timer (a second ``Simulator`` on the
    same run directory) has written it, the whole log is written anew."""
    path = str(tmp_path / 'phase_timings.json')
    timer, other = PhaseTimer(), PhaseTimer()
    with timer.span('a'):
        pass
    timer.dump(path)
    os.remove(path)
    with timer.span('b'):
        pass
    timer.dump(path)
    assert _load(path) == timer.records
    # two timers' dumps in turns: the file is always the last writer's
    for i in range(3):
        for t, name in ((other, 'z'), (timer, 'c')):
            with t.span(name, i=i):
                pass
            t.dump(path)
            assert _load(path) == t.records
    # and a dump that follows its own appends again
    with timer.span('d'):
        pass
    assert timer.dump(path) < os.path.getsize(path) / 2
    assert _load(path) == timer.records


@pytest.mark.parametrize('fn', ['_cycle', '_smooth', '_apply_lap',
                                '_apply_lap_padded', '_deflate', 'vcycle'])
def test_no_span_below_the_vcycle(fn):
    src = inspect.getsource(getattr(lap, fn))
    for word in ('span(', 'count(', 'record_function', 'read_host',
                 '_fetch(', '_host('):
        assert word not in src, (fn, word)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """A uniform run and a direction sweep (batched solve) on the CPU."""
    root = str(tmp_path_factory.mktemp('spans'))
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=root, run_name='one', **CONFIG), device='cpu')
        one.simulate_tracks()
        one.compute_presence_map()
        sweep = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
            out_dir=root, run_name='sweep', potential_batch=2, **CONFIG),
            device='cpu')
        sweep.simulate_direction_sweep([0., 180.])
        sweep.compute_presence_map()
    finally:
        torch.set_num_threads(saved)
    return one, sweep


# the records a run made before the spans, with their fields
OLD_FIELDS = {
    'terrain': set(), 'turbines': set(), 'updrafts': set(),
    'thermals': {'realizations'},
    'potential': {'id', 'solver', 'rrel', 'fallback', 'passes', 'vcycles'},
    'tracks': {'recorded', 'id', 'devices', 'steps', 'useful_steps'},
    'batched_tracks': {'cases', 'devices', 'steps', 'useful_steps'},
    'simulate_tracks': {'tracks', 'cases'}, 'presence_map': set()}


def test_old_records_keep_names_fields_and_order(runs):
    one, sweep = runs
    old = [r for r in one.timer.records if r['phase'] in OLD_FIELDS]
    assert [r['phase'] for r in old] == [
        'terrain', 'turbines', 'updrafts', 'thermals', 'potential',
        'tracks', 'simulate_tracks', 'presence_map']
    counters = {'tracks': {'alive_wait_s'}, 'batched_tracks': {'alive_wait_s'},
                'potential': {'resolves', 'fallbacks', 'resolve_rrel'}}
    sweep_old = [r for r in sweep.timer.records if r['phase'] in OLD_FIELDS]
    for rec in old + sweep_old:
        want = {'phase', 'seconds'} | OLD_FIELDS[rec['phase']]
        if rec['phase'] == 'potential' and 'batch' in rec:
            want |= {'batch', 'group_seconds'}
        assert want <= set(rec), rec
        assert set(rec) - want <= NEW_FIELDS | counters.get(
            rec['phase'], set()), rec
    assert [r['phase'] for r in sweep_old].count('potential') == 2


def test_solve_spans_of_a_run(runs):
    one, _ = runs
    recs = one.timer.records
    by = {r['span']: r for r in recs}
    solve, = [r for r in recs if r['phase'] == 'potential.solve']
    pot, = [r for r in recs if r['phase'] == 'potential']
    assert solve['iterations'] == pot['vcycles'] > 0
    assert set(solve) == {'phase', 'seconds', 'iterations', 'read_wait_s'} \
        | NEW_FIELDS
    assert 0. <= solve['read_wait_s'] < solve['seconds']
    assert by[solve['parent']]['phase'] == 'simulate_tracks'
    passes = [r for r in recs if r['phase'] == 'potential.pass']
    its = [r for r in recs if r['phase'] == 'potential.iteration']
    assert len(passes) == pot['passes'] > 0 and len(its) == pot['vcycles']
    assert all(p['parent'] == solve['span'] for p in passes)
    assert {by[i['parent']]['phase'] for i in its} == {'potential.pass'}
    for name in ('potential.labels', 'potential.levels'):
        rec, = [r for r in recs if r['phase'] == name]
        assert rec['parent'] == solve['span']
    tracks, = [r for r in recs if r['phase'] == 'tracks']
    assert tracks['alive_wait_s'] >= 0.


def test_facade_spans_of_a_run(runs):
    one, _ = runs
    recs = one.timer.records
    by = {r['span']: r for r in recs}
    top = [r['phase'] for r in recs if r['parent'] is None]
    assert top == ['init', 'simulate_tracks', 'save.phase_log',
                   'presence_map', 'save.phase_log']
    init, = [r for r in recs if r['phase'] == 'init']
    assert init['span'] == 0
    for name, parent in (('terrain', 'init'), ('updrafts', 'init'),
                         ('save.config', 'init'),
                         ('terrain.reproject', 'updrafts'),
                         ('save.orographs', 'updrafts'),
                         ('save.potential', 'simulate_tracks'),
                         ('save.counts', 'simulate_tracks'),
                         ('save.summary', 'presence_map')):
        rec, = [r for r in recs if r['phase'] == name]
        assert by[rec['parent']]['phase'] == parent, name
        assert set(rec) == {'phase', 'seconds'} | NEW_FIELDS, name
    # the log on disk: every record, its own last save's too
    with open(os.path.join(one.out_dir, 'one', 'phase_timings.json')) as f:
        assert json.load(f) == recs


def test_sweep_spans(runs, tmp_path):
    _, sweep = runs
    recs = sweep.timer.records
    by = {r['span']: r for r in recs}
    top = [r['phase'] for r in recs if r['parent'] is None]
    assert top == ['init', 'direction_sweep', 'save.phase_log',
                   'presence_map', 'save.phase_log']
    solve, = [r for r in recs if r['phase'] == 'potential.solve']
    pots = [r for r in recs if r['phase'] == 'potential']
    assert all(p['batch'] == 2 for p in pots)
    # the GCR's loop turns, one V-cycle of the whole batch each: as many
    # as a pass's longest case ran
    vcycles = [p['vcycles'] for p in pots]
    assert max(vcycles) <= solve['iterations'] <= sum(vcycles)
    passes = [r for r in recs if r['phase'] == 'potential.pass']
    assert len(passes) == max(p['passes'] for p in pots)
    batched, = [r for r in recs if r['phase'] == 'batched_tracks']
    assert by[batched['parent']]['phase'] == 'direction_sweep'
    assert batched['alive_wait_s'] >= 0.
    # a new Simulator on the cached potentials loads them under spans
    again = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=sweep.out_dir, run_name='sweep', potential_batch=2,
        **CONFIG), device='cpu')
    again.simulate_direction_sweep([0., 180.])
    loads = [r for r in again.timer.records
             if r['phase'] == 'potential.load']
    assert len(loads) == 2
    assert not [r for r in again.timer.records
                if r['phase'] in ('potential.solve', 'save.potential')]
