"""Seconds a job of the artifacts' saves (the ``save.*`` spans: the
configuration, orographs, potentials, counts, summary and phase log),
averaged over the window."""

from benchmark.spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, 'save.')
