"""The trace reader's naming of idle gaps: the innermost range the host
was in, found by one sweep, as the rule states it."""

import random

from benchmark import devtrace


def _brute(phases, x):
    inside = [p for p in phases if p[0] <= x <= p[1]]
    return min(inside, key=lambda p: p[1] - p[0])[2] if inside else 'job'


def _nested(rng, lo, hi, depth, out):
    """Random ranges inside [lo, hi], children inside their parent."""
    t = lo
    while depth and t < hi:
        s = t + rng.random() * (hi - t) * 0.3
        e = s + rng.random() * (hi - s)
        out.append((s, e, f'r{len(out)}'))
        _nested(rng, s, e, depth - 1, out)
        t = e + rng.random() * (hi - e) * 0.2


def test_innermost_is_the_shortest_holder():
    rng = random.Random(5)
    for trial in range(20):
        phases = []
        _nested(rng, 0., 1000., 4, phases)
        # overlapping, equal and identical ranges as well
        for _ in range(5):
            s = rng.random() * 1000.
            phases.append((s, s + rng.random() * 100., f'o{_}'))
        phases.append(phases[0][:2] + ('twin',))
        phases.sort()
        points = sorted(rng.random() * 1100. - 50. for _ in range(300))
        points += [p[0] for p in phases[:3]] + [phases[-1][1]]
        points.sort()
        assert devtrace.innermost(phases, points) == [
            _brute(phases, x) for x in points], trial


def test_no_ranges_is_job():
    assert devtrace.innermost([], [1., 2.]) == ['job', 'job']
