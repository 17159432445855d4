"""Seconds of the ``updrafts`` phase record a job, averaged over the window."""

from benchmark.readers import mean_phase


def read(ctx):
    return mean_phase(ctx, 'updrafts')
