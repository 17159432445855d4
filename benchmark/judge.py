"""Whether the timed path's outputs are correct: the program's outputs
held against the plain reference (``reference.py``), number by number,
each against its limit in ``benchmark/limits/<cell>.json``.

The numbers:

- ``updraft_gap``: the largest |thresholded updraft - reference| in m/s,
  over the jobs' cases (every job's where each job builds its fields, the
  last job's where they share them);
- ``potential_resid``: the largest interior residual max |x - P x| of a
  potential (0..1000) in the row-normalized system of the program's own
  thresholded updraft, which the first number judged: the system's
  near-null modes leave the solution's values undetermined to far more
  than its residual, so no comparison of values certifies a solve;
- ``counts_l1``: for each case, the counts of :data:`COUNT_JOBS` jobs
  drawn from the seed (:class:`Sample`), summed, against the exact expectation of their summed
  starts under the reference's move probabilities (from the reference's
  updraft and the potential the jobs ran on), as the L1 distance of sums
  over :data:`COUNTS_BLOCK` x :data:`COUNTS_BLOCK` cells over the
  expected total;
  the largest over the cases;
- ``counts_mass``: for each case, |total of those counts - its
  expectation| over the expectation (the mean track length, which a
  biased walk moves first); the largest over the cases;
- ``summary_gap``: the largest |summary map - reference| of the drawn
  jobs, the reference's map smoothed from the job's own counts.

Every number is a distance: the run is correct when each is at most its
limit."""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch
import torch.nn.functional as F

from . import reference as ref
from . import terrain

NAMES = ('updraft_gap', 'potential_resid', 'counts_l1', 'counts_mass',
         'summary_gap')
# the jobs whose counts and summaries are judged (every job of a window
# that holds fewer), and the side of the blocks of cells whose sums
# ``counts_l1`` compares
COUNT_JOBS = 24
COUNTS_BLOCK = 5


def case_id(speed: float, dirn: float) -> str:
    """The program's case name of a uniform wind (``s{speed}d{dirn}``)."""
    return f's{int(speed)}d{int(dirn)}'


def reference_fields(cfg: dict, dem, dem_bounds, device):
    """{case: the reference's thresholded updraft (float64 on device)}."""
    z = torch.as_tensor(terrain.reproject(dem, dem_bounds, cfg),
                        device=device)
    slope, aspect = ref.slope_aspect(z, float(cfg['resolution']))
    speed = float(cfg['uniform_windspeed'])
    dirns = cfg.get('wind_directions') or [cfg['uniform_winddirn']]
    return {case_id(speed, d): ref.threshold(
        ref.orograph(slope, aspect, speed, float(d)),
        float(cfg['updraft_threshold'])) for d in dirns}


def block_l1(got: torch.Tensor, want: torch.Tensor, block: int) -> float:
    """sum |got - want| over blocks of block x block cells, over the sum
    of ``want``."""
    pad = (0, -want.shape[-1] % block, 0, -want.shape[-2] % block)
    g = F.avg_pool2d(F.pad(got, pad)[None, None], block)[0, 0]
    w = F.avg_pool2d(F.pad(want, pad)[None, None], block)[0, 0]
    return float((g - w).abs().sum() / w.sum())


def starts(cfg: dict, draws, tracks: int) -> list:
    """(rows, cols) of each start draw ``(rng seed, index)``: the index-th
    draw of the run's NumPy generator, each generator replayed once."""
    found = {}
    for seed in {d[0] for d in draws}:
        wanted = {d[1] for d in draws if d[0] == seed}
        rng = np.random.default_rng(seed)
        for i in range(max(wanted) + 1):
            rc = ref.starting_indices(
                tracks, list(cfg['track_start_region']),
                cfg['track_start_type'], tuple(cfg['region_width_km']),
                float(cfg['resolution']), rng)
            if i in wanted:
                found[(seed, i)] = rc
    return [found[tuple(d)] for d in draws]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def numbers(cfg: dict, ref_thr: dict, field_outputs: list,
            count_jobs: list, tracks: int, device) -> dict:
    """The five numbers. ``field_outputs``: the outputs (``Traffic.outputs``)
    whose fields and potentials are judged; ``count_jobs``: ``(draws,
    outputs)`` of the jobs whose counts and summaries are judged, the
    draws (:func:`starts`) those of the job's tracks."""
    dirn = float(cfg['track_direction'])
    out = {'updraft_gap': 0., 'potential_resid': 0.}
    for o in field_outputs:
        for case, want in ref_thr.items():
            got = o['thresholded'][case].to(torch.float64)
            out['updraft_gap'] = max(out['updraft_gap'],
                                     float((got - want).abs().max()))
            out['potential_resid'] = max(
                out['potential_resid'], ref.interior_residual(
                    o['potential'][case], got, dirn))
    shape = next(iter(ref_thr.values())).shape
    burnin = int(min(shape) / 10)
    nsteps = int(cfg['track_max_steps'])
    drawn = [d for draws, _ in count_jobs for d in draws]
    found = dict(zip(drawn, starts(cfg, drawn, tracks)))
    hists = [sum(ref.start_histogram(*found[d], shape, device)
                 for d in draws) for draws, _ in count_jobs]
    # every (case, potential) group's expectation in one pass
    trans, starts_g, case_of = [], [], []
    for case, thr in ref_thr.items():
        groups = {}  # the jobs by the potential they ran on
        for hist, (_, o) in zip(hists, count_jobs):
            pot = o['potential'][case]
            g = groups.setdefault(_digest(pot), [pot, torch.zeros_like(hist)])
            g[1] += hist
        for pot, hist in groups.values():
            trans.append(ref.transitions(
                ref.move_table(thr, pot, dirn), dirn,
                int(cfg['track_dirn_restrict']),
                float(cfg['track_stochastic_nu'])))
            starts_g.append(hist)
            case_of.append(case)
    expect = ref.expected_counts(torch.stack(trans), torch.stack(starts_g),
                                 burnin, nsteps)
    del trans
    out['counts_l1'] = out['counts_mass'] = 0.
    for case in ref_thr:
        want = sum(e for e, c in zip(expect, case_of) if c == case)
        got = sum(o['counts'][case] for _, o in count_jobs)
        out['counts_l1'] = max(out['counts_l1'], block_l1(
            got, want, COUNTS_BLOCK))
        out['counts_mass'] = max(out['counts_mass'], abs(float(
            (got.sum() - want.sum()) / want.sum())))
    krad = ref.kernel_radius(1000., float(cfg['resolution']), shape)
    out['summary_gap'] = 0.
    for _, o in count_jobs:
        counts = torch.stack([o['counts'][c] for c in ref_thr])
        want = ref.summary_map(counts, krad)
        out['summary_gap'] = max(out['summary_gap'],
                                 float((o['summary'] - want).abs().max()))
    return out


class Sample:
    """:data:`COUNT_JOBS` jobs of a stream, each as likely as any other,
    drawn from the seed as the jobs come (reservoir sampling), so that the
    outputs of the rest can go at once."""

    def __init__(self, seed: int):
        self._rng = random.Random(int(seed))
        self.kept = []
        self.seen = 0

    def add(self, job):
        """Offer ``job``; returns the job that is not kept (``job`` or
        the one it replaces), or None."""
        self.seen += 1
        if len(self.kept) < COUNT_JOBS:
            self.kept.append(job)
            return None
        slot = self._rng.randrange(self.seen)
        if slot >= COUNT_JOBS:
            return job
        out, self.kept[slot] = self.kept[slot], job
        return out


def verdict(values: dict, limits: dict):
    """(correct, {name: {value, limit}})."""
    checks = {n: {'value': values[n], 'limit': limits[n]} for n in NAMES}
    return all(c['value'] <= c['limit'] for c in checks.values()), checks
