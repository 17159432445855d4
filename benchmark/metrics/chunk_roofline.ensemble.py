"""The chunk kernel's share of its roofline in the traced job: the least
time the job's moves need (``roofline.track_bound``: live agent-steps at
``move_flops`` operations, each visited cell's table row and count once)
over the device time of the kernels named ``*fused_chunk*``."""

import numpy as np

from benchmark import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    secs = sum(v for k, v in ctx.trace['kernels'].items()
               if 'fused_chunk' in k)
    if secs <= 0:
        return None
    job = ctx.trace['job']
    cells, shape = 0, None
    for case in job.cases:
        counts = np.load(job.counts_path(case))
        shape = counts.shape
        cells += int(np.count_nonzero(counts))
    live = ctx.traffic.useful_steps(job)
    bound, _ = roofline.track_bound(
        live, int(ctx.config['track_dirn_restrict']), cells,
        roofline.table_row_bytes(ctx.config['track_weight_precision'],
                                 shape))
    return 100. * bound / secs
