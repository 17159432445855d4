"""Milliseconds of a GCR iteration: the mean ``potential.iteration`` span
over the window's jobs (one V-cycle, the orthogonalization, the residual
and the next exit test's host read, without the solve's set-up and its
refinement passes' own work)."""


def read(ctx):
    secs = [r['seconds'] for j in ctx.jobs for r in j.records
            if r['phase'] == 'potential.iteration']
    return 1e3 * sum(secs) / len(secs) if secs else None
