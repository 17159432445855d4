"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every name it gives resolves to a file, and a configuration, mix, limits
file and metric added as new files in a copy are found without an edit."""

import json
import os
import re
import shutil

import pytest

from benchmark import cells, harness
from conftest import REPO

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


@pytest.fixture(scope='module')
def spec():
    return cells.load_spec(REPO)


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level(spec):
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert spec['command'] == ['python3', 'benchmark/run.py']
    assert spec['paths'] == ['benchmark']
    assert isinstance(spec['run_seconds'], int)
    assert 1 <= spec['run_seconds'] <= 51
    n_cells = 24
    check_s = (2 + 14 * n_cells) * (spec['run_seconds'] + 60) \
        + n_cells * 2 * 90 + 1200
    assert check_s <= 43200
    assert os.path.getsize(os.path.join(REPO, 'BENCHMARK.json')) <= 65536


@pytest.mark.parametrize('group', sorted(KEYS))
def test_entries(spec, group):
    names = [e['name'] for e in spec[group]]
    assert len(names) == len(set(names))
    for e in spec[group]:
        extra = {'workloads'} if group in ('end_to_end', 'per_layer') \
            else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e['name']
        assert NAME.match(e['name']), e['name']
        for key in ('why', 'layer', 'source'):
            if key in e and group != 'end_to_end' and group != 'per_layer':
                assert _line(e[key]), (e['name'], key)
        if group in ('end_to_end', 'per_layer'):
            assert UNIT.match(e['unit']) and e['better'] in ('lower',
                                                               'higher')
            assert e['source'] in ('device_trace', 'program_span',
                                   'program_counter', 'host_clock')


def test_metrics_and_cells(spec):
    cell_names = {w['name'] for w in spec['workloads']}
    e2e = {m['name']: m for m in spec['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in spec['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
        assert set(m.get('workloads', cell_names)) <= cell_names
    layers = {}
    for m in spec['per_layer']:
        assert m['moves'] in e2e and _line(m['layer'])
        assert set(m.get('workloads', cell_names)) <= cell_names
        for cell in m.get('workloads', []):
            assert cell in e2e[m['moves']].get('workloads', [cell])
    for cell in cell_names:
        e = cells.cell_metrics(spec, cell, False)
        assert 'setup_s' in [m['name'] for m in e] and len(e) >= 2
        assert cells.cell_metrics(spec, cell, True)


def test_configs_and_workloads(spec):
    used = {w['config'] for w in spec['workloads']}
    assert used == {c['name'] for c in spec['configs']}
    pairs = [(w['config'], w['traffic']) for w in spec['workloads']]
    assert len(pairs) == len(set(pairs))
    files = [c['file'] for c in spec['configs']]
    assert len(files) == len(set(files))
    for c in spec['configs']:
        assert c['file'].startswith('benchmark/') and _line(c['source'])
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        doc = cells.load_config(REPO, spec, c['name'])
        assert doc['reduced'] == c['reduced']
        assert doc['source'] == c['source']
    four = [w for w in spec['workloads'] if w['chips'] == 4]
    assert len(four) <= max(1, len(spec['workloads']) // 4)
    for w in spec['workloads']:
        assert w['chips'] in (1, 4) and _line(w['why'])
        assert NAME.match(w['config']) and NAME.match(w['traffic'])


def test_every_name_resolves(spec):
    for w in spec['workloads']:
        cells.load_traffic(REPO, w['traffic'])
        limits = cells.load_limits(REPO, w['name'])
        assert set(limits) == {'updraft_gap', 'potential_resid',
                               'counts_l1', 'counts_mass', 'summary_gap'}
    for m in spec['end_to_end'] + spec['per_layer']:
        assert callable(cells.metric_reader(REPO, m['name']))


def test_added_by_files_alone(tmp_path):
    """A new configuration, mix, cell, limits and per-layer metric, each
    a new file plus new entries, run without an existing file edited."""
    from conftest import make_tiny_root
    root = make_tiny_root(str(tmp_path))
    bench = os.path.join(root, 'benchmark')
    before = {p: open(os.path.join(bench, p), 'rb').read()
              for p in ('traffic.py', 'harness.py', 'cells.py', 'judge.py')}
    with open(os.path.join(bench, 'configs', 'wy_uniform.json')) as f:
        doc = json.load(f)
    doc['uniform_winddirn'] = 225.
    with open(os.path.join(bench, 'configs', 'wy_sw.json'), 'w') as f:
        json.dump(doc, f)
    with open(os.path.join(bench, 'traffic', 'redraw.json'), 'w') as f:
        json.dump({'tracks_per_case': 1000,
                   'share_potentials': True}, f)
    shutil.copy(os.path.join(bench, 'limits', 'wy_uniform.run.json'),
                os.path.join(bench, 'limits', 'wy_sw.redraw.json'))
    with open(os.path.join(bench, 'metrics', 'jobs_n.redraw.py'), 'w') as f:
        f.write('def read(ctx):\n    return float(len(ctx.jobs))\n')
    spec_path = os.path.join(root, 'BENCHMARK.json')
    with open(spec_path) as f:
        spec = json.load(f)
    spec['configs'].append({'name': 'wy_sw', 'source': 'a test',
                            'file': 'benchmark/configs/wy_sw.json',
                            'reduced': doc['reduced'], 'why': 'a test'})
    spec['workloads'].append({'name': 'wy_sw.redraw', 'config': 'wy_sw',
                              'traffic': 'redraw', 'chips': 1,
                              'why': 'a test'})
    spec['end_to_end'][0]['workloads'].append('wy_sw.redraw')
    spec['per_layer'].append({'name': 'jobs_n.redraw', 'unit': 'jobs',
                              'better': 'higher', 'source': 'host_clock',
                              'layer': 'Facade', 'moves': 'run_s',
                              'workloads': ['wy_sw.redraw']})
    with open(spec_path, 'w') as f:
        json.dump(spec, f)
    res = harness.run_cell(root, 'wy_sw.redraw', 7, 0.5, True, 'cpu')
    assert res['metrics']['jobs_n.redraw']['value'] >= 1
    assert res['correct'] is True
    after = {p: open(os.path.join(bench, p), 'rb').read() for p in before}
    assert after == before
