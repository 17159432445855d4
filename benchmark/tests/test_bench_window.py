"""Each cell's traffic through the window loop on the CPU at the tiny cut
(``conftest.TINY_CONFIG``), and the shape of the result line."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import cells, harness, traffic
from conftest import REPO

CELLS = [w['name'] for w in cells.load_spec(REPO)['workloads']]


def _shape(res, spec, cell, trace):
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(res)[-1] == 'checks'
    assert res['attempted'] >= 1 and res['failed'] == 0
    want = {m['name']: m['unit']
            for m in cells.cell_metrics(spec, cell, trace)}
    for name, m in res['metrics'].items():
        assert m['unit'] == want[name] and m['value'] == m['value']
    dev = res['device']
    assert set(dev) >= {'platform', 'kind', 'count', 'memory_peak_bytes'}
    if trace:
        assert 'busy_s' in dev and 'window_s' in dev
        for key in ('device_ops', 'idle_gaps'):
            assert len(res['breakdown'][key]) <= 10
    for name, c in res['checks'].items():
        assert set(c) == {'value', 'limit'}
    json.dumps(res)


@pytest.mark.parametrize('trace', [False, True])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs(tiny_root, cell, trace, one_thread):
    spec = cells.load_spec(tiny_root)
    res = harness.run_cell(tiny_root, cell, 2 ** 31 + 11, 0.5, trace, 'cpu')
    _shape(res, spec, cell, trace)
    assert res['correct'] is True, res['checks']
    if not trace:
        assert set(res['metrics']) == {m['name'] for m in
                                       cells.cell_metrics(spec, cell, False)}


def test_job_seeds():
    seeds = {traffic.job_seed(s, k) for s in (-3, 0, 2 ** 31 + 5)
             for k in (0, 1, 'setup')}
    assert len(seeds) == 9
    assert all(0 <= s < 2 ** 56 for s in seeds)
    assert traffic.job_seed(5, 1) == traffic.job_seed(5, 1)


def test_sample_of_jobs():
    """The jobs whose counts are judged: judge.COUNT_JOBS of them, the
    same for a seed, each job as likely as any; every other job is given
    back for its outputs to go."""
    from benchmark import judge
    k, n = judge.COUNT_JOBS, 40

    def run(seed):
        sample, dropped = judge.Sample(seed), []
        for i in range(n):
            out = sample.add(i)
            if out is not None:
                dropped.append(out)
        assert sorted(sample.kept + dropped) == list(range(n))
        return sorted(sample.kept)

    assert run(3) == run(3) and len(run(3)) == k
    hits = [0] * n
    for seed in range(2000):
        for i in run(seed):
            hits[i] += 1
    assert min(hits) > 0.7 * 2000 * k / n and max(hits) < 1.3 * 2000 * k / n
    short = judge.Sample(5)
    assert [short.add(i) for i in range(k)] == [None] * k


def test_only_the_sample_keeps_its_counts(tiny_root, one_thread,
                                          monkeypatch):
    """After a run of the shared mix only the sampled jobs' counts were
    on disk: the rest went as the window ran (a sample of 2 and 1,000
    tracks a case, for more jobs than the sample holds)."""
    import json
    from benchmark import cells, judge
    spec = cells.load_spec(tiny_root)
    cell = next(w for w in spec['workloads']
                if cells.load_traffic(tiny_root, w['traffic'])[
                    'share_potentials'])
    path = os.path.join(tiny_root, 'benchmark', 'traffic',
                        f'{cell["traffic"]}.json')
    with open(path, encoding='utf-8') as f:
        mix = json.load(f)
    mix['tracks_per_case'] = 1000
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(mix, f)
    monkeypatch.setattr(judge, 'COUNT_JOBS', 2)
    seen = []
    orig = traffic.Traffic.drop_outputs

    def drop(self, job):
        orig(self, job)
        seen.append(job)
        assert not os.path.exists(job.summary_path())

    import unittest.mock
    with unittest.mock.patch.object(traffic.Traffic, 'drop_outputs', drop):
        res = harness.run_cell(tiny_root, cell['name'], 9, 4., False,
                               'cpu')
    assert set(res['checks']) == set(judge.NAMES)
    assert len(seen) == res['attempted'] - judge.COUNT_JOBS > 0


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints
    nothing on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', CELLS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=REPO,
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ''


def test_bare_directory_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero with no result."""
    import shutil
    shutil.copytree(os.path.join(REPO, 'benchmark'),
                    os.path.join(tmp_path, 'benchmark'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', CELLS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ''
