"""Cases a job whose winds an interpolation plan built before served: the
``plan_hits`` counters of the ``wtk_interp`` records (one a case; the
first case of a job builds the plan), averaged over the window. None for
a program whose records have no such counter."""

from benchmark.spans import mean_counter


def read(ctx):
    return mean_counter(ctx, 'wtk_interp', 'plan_hits')
