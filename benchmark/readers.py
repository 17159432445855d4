"""Helpers of the metric readers in ``metrics/``: what a run's context
(``harness.run_cell``) holds, summed and averaged."""

from __future__ import annotations


def phase_seconds(job, name: str) -> float:
    """Seconds of a job's ``Simulator`` phase records named ``name``."""
    return sum(r['seconds'] for r in job.records if r['phase'] == name)


def mean_phase(ctx, name: str):
    """Seconds of phase ``name`` a job, averaged over the window's jobs;
    None where no job has the phase."""
    if not any(r['phase'] == name for j in ctx.jobs for r in j.records):
        return None
    return sum(phase_seconds(j, name) for j in ctx.jobs) / len(ctx.jobs)


def idle_percent(ctx):
    """The device's idle share of a job, in percent: 1 - the traced
    job's device-busy seconds over the mean wall of the window's jobs,
    which the profiler did not slow."""
    if ctx.trace is None or ctx.trace['busy_s'] <= 0 or not ctx.jobs:
        return None
    wall = sum(j.wall for j in ctx.jobs) / len(ctx.jobs)
    return 100. * (1. - ctx.trace['busy_s'] / wall)


def peak_gib(ctx):
    """Peak device memory allocated in the window, GiB."""
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
