"""Fallbacks a job: the ``fallbacks`` counters of the ``potential``
records (a solve replaced by the host's float64 direct solve), averaged
over the window. None for a program whose records have no such
counter."""

from benchmark.spans import mean_counter


def read(ctx):
    return mean_counter(ctx, 'potential', 'fallbacks')
