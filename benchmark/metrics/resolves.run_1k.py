"""Re-solves a job: the ``resolves`` counters of the ``potential``
records (a refined solve that ended above the re-solve trigger, solved
again on the card), averaged over the window. None for a program whose
records have no such counter."""

from benchmark.spans import mean_counter


def read(ctx):
    return mean_counter(ctx, 'potential', 'resolves')
