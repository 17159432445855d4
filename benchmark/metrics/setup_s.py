"""Set-up: the program's import and first use, the DEM, the warm-up job
(or, with shared potentials, the job that solves and caches them and
one that finds them cached)."""


def read(ctx):
    return ctx.setup_s
