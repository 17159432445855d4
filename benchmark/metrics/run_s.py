"""Seconds a job: the window's elapsed time over the jobs it finished."""


def read(ctx):
    return ctx.elapsed / len(ctx.jobs) if ctx.jobs else None
