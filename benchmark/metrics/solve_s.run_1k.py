"""Seconds of the ``potential`` records (the solves, with their re-solves
and fallbacks) a job, averaged over the window."""

from benchmark.readers import mean_phase


def read(ctx):
    return mean_phase(ctx, 'potential')
