"""Seconds a job outside its ``batched_tracks`` and ``presence_map``
records (the ``Simulator``'s construction with the raster's
reprojection, the potentials' load, the orographs, starts, tables,
saves), averaged over the window."""

from benchmark.readers import phase_seconds


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(j.wall - phase_seconds(j, 'batched_tracks')
               - phase_seconds(j, 'presence_map')
               for j in ctx.jobs) / len(ctx.jobs)
