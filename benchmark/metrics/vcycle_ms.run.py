"""Milliseconds a V-cycle: the ``potential`` records' seconds over their
``vcycles``, over the window's jobs."""


def read(ctx):
    recs = [r for j in ctx.jobs for r in j.records
            if r['phase'] == 'potential' and r.get('vcycles')]
    if not recs:
        return None
    return 1e3 * sum(r['seconds'] for r in recs) / sum(r['vcycles']
                                                       for r in recs)
