"""Seconds a job the host waited for the card in the solve's host reads
(the ``read_wait_s`` counter of the ``potential.solve`` spans: the exit
tests, the passes' residuals, the scale and the labels' copies), averaged
over the window."""

from benchmark.spans import mean_counter


def read(ctx):
    return mean_counter(ctx, 'potential.solve', 'read_wait_s')
