"""Seconds a job the multi-case driver's host waited for the card in its
alive-count reads (the ``alive_wait_s`` counter of the ``batched_tracks``
record), averaged over the window."""

from benchmark.spans import mean_counter


def read(ctx):
    return mean_counter(ctx, 'batched_tracks', 'alive_wait_s')
