"""Seconds a job of reading the WTK archive: its ``wtk_download`` (the
sites and hours of the run's datetimes read from the local archive) and
``wtk_frame`` (each case's frame) records, averaged over the window."""

from benchmark.readers import phase_seconds


def read(ctx):
    names = ('wtk_download', 'wtk_frame')
    if not any(r['phase'] in names for j in ctx.jobs for r in j.records):
        return None
    return sum(phase_seconds(j, n) for j in ctx.jobs
               for n in names) / len(ctx.jobs)
