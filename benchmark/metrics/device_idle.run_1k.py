"""The device's idle share of a job: 1 - (union of device activity in
the traced job) / (the mean wall of the window's untraced jobs), in
percent."""

from benchmark.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
