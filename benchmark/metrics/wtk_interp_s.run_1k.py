"""Seconds a job of the winds' interpolation onto the grid (the
``wtk_interp`` records: the host's ``griddata``), averaged over the
window."""

from benchmark.readers import mean_phase


def read(ctx):
    return mean_phase(ctx, 'wtk_interp')
