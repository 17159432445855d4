"""The share of the window's GCR iterations that ran as replays of a
CUDA graph: the ``graph_replays`` counters of the jobs' ``potential.solve``
spans over their ``iterations`` counters. None where no solve counts a
replay (a program without the graph) or none counts an iteration."""

from benchmark.spans import counter_total


def read(ctx):
    reps = [counter_total(j, 'potential.solve', 'graph_replays')
            for j in ctx.jobs]
    its = [counter_total(j, 'potential.solve', 'iterations')
           for j in ctx.jobs]
    if all(r is None for r in reps):
        return None
    n_its = sum(i for i in its if i is not None)
    return sum(r for r in reps if r is not None) / n_its if n_its else None
