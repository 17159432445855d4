"""Agent-steps that moved a track over the seconds of the
``batched_tracks`` records, which synchronize the device."""

from benchmark.readers import phase_seconds


def read(ctx):
    secs = sum(phase_seconds(j, 'batched_tracks') for j in ctx.jobs)
    if secs <= 0:
        return None
    return sum(ctx.useful_steps[j.label] for j in ctx.jobs) / secs
