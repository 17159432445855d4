"""Helpers of the metric readers that read the program's span records
(``ssrs_tpu_torch/core/timing.py``): a record per closed span, with
``phase`` (its name), ``seconds``, ``span``, ``parent`` and ``t0_ns``
(its start, ``time.time_ns()``) and the counters added on it. A program
without a span or a counter finds nothing here: each helper then returns
None, never 0."""

from __future__ import annotations


def _named(job, name):
    """The job's records of ``name``: a name, or a tuple of names, or, with
    a trailing ``.``, every name that starts with it."""
    if isinstance(name, str) and name.endswith('.'):
        return [r for r in job.records if r['phase'].startswith(name)]
    names = (name,) if isinstance(name, str) else name
    return [r for r in job.records if r['phase'] in names]


def mean_seconds(ctx, name):
    """Seconds of the records of ``name`` (as :func:`_named`) a job,
    averaged over the window's jobs; None where no job has one."""
    per_job = [_named(j, name) for j in ctx.jobs]
    if not any(per_job):
        return None
    return sum(r['seconds'] for recs in per_job for r in recs) / len(ctx.jobs)


def mean_counter(ctx, name: str, counter: str):
    """The counter ``counter`` of the records of ``name`` a job, averaged
    over the window's jobs; None where no such record has it."""
    vals = [[r[counter] for r in _named(j, name) if counter in r]
            for j in ctx.jobs]
    if not any(vals):
        return None
    return sum(v for job in vals for v in job) / len(ctx.jobs)


def counter_total(job, name: str, counter: str):
    """The sum of the counter over the job's records of ``name``; None
    where none has it."""
    vals = [r[counter] for r in _named(job, name) if counter in r]
    return sum(vals) if vals else None


def unspanned_seconds(job):
    """The job's wall minus the union of its top-level spans (``parent``
    None, from ``t0_ns`` and ``seconds``): what no span explains; None
    where its records have no span fields."""
    if not job.records or any('t0_ns' not in r for r in job.records):
        return None
    spans = sorted((r['t0_ns'] * 1e-9, r['t0_ns'] * 1e-9 + r['seconds'])
                   for r in job.records if r['parent'] is None)
    covered, end = 0., float('-inf')
    for s, e in spans:
        if e > end:
            covered += e - max(s, end)
            end = e
    return job.wall - covered
