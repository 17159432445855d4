"""Seconds a job that no span explains: the job's wall minus the union
of its top-level spans (from their ``t0_ns`` and ``seconds``), averaged
over the window."""

from benchmark.spans import unspanned_seconds


def read(ctx):
    vals = [unspanned_seconds(j) for j in ctx.jobs]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals)
