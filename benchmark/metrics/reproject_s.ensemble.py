"""Seconds a job of the raster's reprojection onto the run's grid (the
``terrain.reproject`` span, at the first read of the raster), averaged
over the window."""

from benchmark.spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, 'terrain.reproject')
