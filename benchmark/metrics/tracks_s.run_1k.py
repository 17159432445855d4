"""Seconds a job of the recorded tracks: the ``tracks`` records (the
recording driver, case by case) and the ``write_tracks`` records (each
case's ``.pkl``), averaged over the window."""

from benchmark.readers import phase_seconds


def read(ctx):
    names = ('tracks', 'write_tracks')
    if not any(r['phase'] in names for j in ctx.jobs for r in j.records):
        return None
    return sum(phase_seconds(j, n) for j in ctx.jobs
               for n in names) / len(ctx.jobs)
