"""Agent-steps that moved a track, of every job in the window (presence
mass minus starts, from the saved counts), over the window's elapsed
time."""


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(ctx.useful_steps.values()) / ctx.elapsed
