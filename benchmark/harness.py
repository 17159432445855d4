"""One run of one cell: set-up, the measured window, the traced job, the
check against the plain reference and the result line."""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
import types

import torch

from . import cells, judge, wtkref
from .traffic import Traffic

# top-level module names a run must not have loaded: JAX, its libraries
# and the JAX package the port was made from
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ssrs_tpu')


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``ssrs_tpu_torch`` is not ``ssrs_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def _device_info(device, peak: int, trace) -> dict:
    dev = torch.device(device)
    if dev.type == 'cuda':
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
                'count': 1}
    else:
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
    info['memory_peak_bytes'] = int(peak)
    if trace is not None:
        info['busy_s'] = trace['busy_s']
        info['window_s'] = trace['window_s']
    return info


def _peak(device, reset: bool = False) -> int:
    if torch.device(device).type != 'cuda':
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def run_cell(root: str, cell_name: str, seed: int, seconds: float,
             trace: bool, device='cuda:0', t_start=None) -> dict:
    """Run ``cell_name`` of ``root``'s BENCHMARK.json and return the
    result line's object. Set-up is timed from ``t_start`` (a
    ``time.perf_counter()`` reading; by default, from this call)."""
    t0 = time.perf_counter() if t_start is None else t_start
    spec = cells.load_spec(root)
    cell = cells.find_cell(spec, cell_name)
    cfg = cells.load_config(root, spec, cell['config'])
    mix = cells.load_traffic(root, cell['traffic'])
    limits = cells.load_limits(root, cell_name)
    metrics = cells.cell_metrics(spec, cell_name, trace)
    readers = {m['name']: cells.metric_reader(root, m['name'])
               for m in metrics}
    workdir = tempfile.mkdtemp(prefix='ssrs_bench_')
    gen = None
    try:
        gen = Traffic(cfg, mix, seed, workdir, device)
        gen.setup()
        setup_s = time.perf_counter() - t0
        peak = _peak(device, reset=True)

        jobs, steps = [], {}
        wtk_run = wtkref.is_wtk(cfg)
        sample = judge.PairSample(seed) if wtk_run else judge.Sample(seed)
        elapsed = 0.
        while elapsed < seconds:
            j = gen.job(len(jobs))
            jobs.append(j)
            elapsed += j.wall
            if not j.failed:
                steps[j.label] = gen.useful_steps(j)
                out = sample.add(j)
                if wtk_run:
                    for job, cases, summary in out:
                        gen.drop_outputs(job, cases, summary)
                elif out is not None:
                    gen.drop_outputs(out)
        for j in jobs:
            phases = {}
            for r in j.records:
                phases[r['phase']] = phases.get(r['phase'], 0.) + r['seconds']
            print(f'job {j.label}: {j.wall:.4f} s; ' + ', '.join(
                f'{k} {v:.4f}' for k, v in phases.items()), file=sys.stderr)
        window_peak = _peak(device)
        peak = max(peak, window_peak)
        failed = [j for j in jobs if j.failed]
        for j in failed:
            print(f'job {j.label} failed:\n{j.failed}', file=sys.stderr)
        done = [j for j in jobs if not j.failed]

        traced = None
        if trace:
            from . import devtrace
            job, traced = devtrace.profile(lambda: gen.job(len(jobs)))
            traced['job'] = job
            print(f'traced job: {job.wall:.3f} s, {traced["launches"]} '
                  f'launches, trace read in {traced["read_s"]:.1f} s',
                  file=sys.stderr)
            peak = max(peak, _peak(device))

        ctx = types.SimpleNamespace(
            jobs=done, elapsed=elapsed, setup_s=setup_s,
            window_peak_bytes=window_peak, trace=traced, config=cfg,
            useful_steps=steps, traffic=gen)
        values = {}
        for m in metrics:
            v = readers[m['name']](ctx)
            if v is not None:
                values[m['name']] = {'value': v, 'unit': m['unit']}

        t_check = time.perf_counter()
        _peak(device, reset=True)
        correct, checks = check(gen, cfg, limits, done, sample, device)
        print(f'check: {time.perf_counter() - t_check:.1f} s, peak '
              f'{_peak(device) / 2 ** 30:.3f} GiB, the expectation to step '
              f'{getattr(judge.ref.expected_counts, "last_step", None)}',
              file=sys.stderr)
        correct = correct and not failed
        result = {'correct': correct, 'attempted': len(jobs),
                  'failed': len(failed), 'metrics': values,
                  'device': _device_info(device, peak, traced)}
        if traced is not None:
            result['breakdown'] = {'device_ops': traced['device_ops'],
                                   'idle_gaps': traced['idle_gaps']}
        result['checks'] = checks
        for name, c in checks.items():
            print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
                  file=sys.stderr)
        return result
    finally:
        if gen is not None:
            gen.close()
        shutil.rmtree(workdir, ignore_errors=True)


def check(gen: Traffic, cfg: dict, limits: dict, jobs: list, sample,
          device):
    """(correct, checks) of the window's jobs, once the program's state
    is freed: the fields and potentials of every job (of the last, where
    the jobs share them), the counts and summaries of the jobs or (job,
    case) pairs ``sample`` kept."""
    if not jobs:
        return False, {n: {'value': float('inf'), 'limit': limits[n]}
                       for n in judge.NAMES}
    gen.sim = None
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    if wtkref.is_wtk(cfg):
        fields = wtkref.Fields(cfg, gen.dem, gen.dem_bounds, device)
        shared = gen.shared and cfg['sim_mode'].lower() == 'snapshot'
        field_pairs = [(j, c) for j in (jobs[-1:] if shared else jobs)
                       for c in j.cases]
        values = judge.wtk_numbers(cfg, fields, gen, field_pairs,
                                   sample.kept, sample.summary_job,
                                   gen.tracks, device)
        return judge.verdict(values, limits)
    ref_thr = judge.reference_fields(cfg, gen.dem, gen.dem_bounds, device)
    field_jobs = jobs[-1:] if gen.shared else jobs
    field_outputs = []
    for j in field_jobs:
        o = gen.outputs(j, device, counts=False)
        field_outputs.append({'thresholded': o['thresholded'],
                              'potential': o['potential']})
    count_jobs = [([j.draw], gen.outputs(j, device))
                  for j in sorted(sample.kept, key=lambda j: j.start)]
    values = judge.numbers(cfg, ref_thr, field_outputs, count_jobs,
                           gen.tracks, device)
    return judge.verdict(values, limits)
