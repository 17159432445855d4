"""Kernel launches a V-cycle: the traced job's launches (every launch of
the job, the few hundred outside the solve included: the fields, the
table, the tracks and the map) over the ``iterations`` of its
``potential.solve`` spans (the GCR's loop turns, one V-cycle each)."""

from benchmark.spans import counter_total


def read(ctx):
    if ctx.trace is None or ctx.trace['launches'] <= 0:
        return None
    its = counter_total(ctx.trace['job'], 'potential.solve', 'iterations')
    return ctx.trace['launches'] / its if its else None
