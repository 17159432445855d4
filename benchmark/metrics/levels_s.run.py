"""Seconds of the solve's host set-up a job, averaged over the window:
the ``potential.labels`` (the islands' labels, ``scipy.ndimage.label``)
and ``potential.levels`` (the level hierarchy, its labels coarsened on
the host) spans."""

from benchmark.spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, ('potential.labels', 'potential.levels'))
