"""Seconds of the ``terrain`` phase record a job, averaged over the window."""

from benchmark.readers import mean_phase


def read(ctx):
    return mean_phase(ctx, 'terrain')
