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

A snapshot or seasonal configuration (WTK winds, ``wtkref.py``) is judged
by case, :func:`wtk_numbers`:

- a job's case ids are the reference's, from the configuration and the
  job's seed (the seasonal sampler's draws); a job whose ids differ is
  not correct (``updraft_gap`` infinite) and nothing else of it is read;
- the fields and potentials of every case of every job (of the last job
  where the jobs share one snapshot's potentials), one case at a time,
  under the reference's interpolated winds;
- the counts of :data:`COUNT_PAIRS` (job, case) pairs drawn from the seed
  (:class:`PairSample`), each pair's expectation from its job's starts
  (the draws after its datetimes) and its case's updraft and potential,
  one at a time, so that the check holds one group's transitions; the
  pairs' counts and expectations are pooled, so that cases of a thousand
  tracks add up to a sample the limits can judge: ``counts_l1`` is the L1
  distance of the pooled sums over :data:`COUNTS_BLOCK` x
  :data:`COUNTS_BLOCK` cells over the pooled expected total,
  ``counts_mass`` the pooled totals' relative gap;
- ``summary_gap`` of one job drawn from the seed, over all its cases.

Every number is a distance: the run is correct when each is at most its
limit."""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch
import torch.nn.functional as F

from . import reference as ref
from . import terrain, wtkref

NAMES = ('updraft_gap', 'potential_resid', 'counts_l1', 'counts_mass',
         'summary_gap')
# the jobs whose counts and summaries are judged (every job of a window
# that holds fewer), and the side of the blocks of cells whose sums
# ``counts_l1`` compares
COUNT_JOBS = 24
COUNTS_BLOCK = 5
# the (job, case) pairs whose counts a WTK configuration's check judges
COUNT_PAIRS = 16


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
    start draw of the run's NumPy generator, each generator replayed once;
    in seasonal mode the datetimes' draws come first."""
    found = {}
    for seed in {d[0] for d in draws}:
        wanted = {d[1] for d in draws if d[0] == seed}
        rng = np.random.default_rng(seed)
        if cfg['sim_mode'].lower() == 'seasonal':
            wtkref.datetimes(cfg, rng)
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


def wtk_numbers(cfg: dict, fields, out, field_pairs: list,
                count_pairs: list, summary_job, tracks: int,
                device) -> dict:
    """The five numbers of a snapshot or seasonal configuration.
    ``fields``: the reference's :class:`wtkref.Fields`; ``out``: the
    reader of the judged outputs (``case_fields``, ``case_counts``,
    ``summary``, as ``Traffic`` has them); ``field_pairs``: the (job, case)
    pairs whose fields and potentials are judged; ``count_pairs``: those
    whose counts are, pooled; ``summary_job``: the job whose summary map
    is. A job has ``label``, ``seed``, ``draw`` and ``cases``."""
    inf = float('inf')
    dirn = float(cfg['track_direction'])
    values = dict.fromkeys(NAMES, 0.)
    jobs = {j.label: j for j, _ in field_pairs + count_pairs}
    if summary_job is not None:
        jobs[summary_job.label] = summary_job
    want = {label: wtkref.cases(cfg, j.seed) for label, j in jobs.items()}
    bad = {label for label, j in jobs.items()
           if sorted(j.cases) != sorted(want[label])}
    if bad:
        values['updraft_gap'] = inf
    for j, case in field_pairs:
        if j.label in bad:
            continue
        thr, pot = out.case_fields(j, case, device)
        got = thr.to(torch.float64)
        wanted = fields.thresholded(want[j.label][case])
        values['updraft_gap'] = max(values['updraft_gap'],
                                    float((got - wanted).abs().max()))
        values['potential_resid'] = max(
            values['potential_resid'],
            ref.interior_residual(pot, got, dirn))
    shape = fields.winds.shape
    pairs = [(j, c) for j, c in count_pairs if j.label not in bad]
    draws = sorted({j.draw for j, _ in pairs})
    hists = {d: ref.start_histogram(*rc, shape, device)
             for d, rc in zip(draws, starts(cfg, draws, tracks))}
    got_sum = want_sum = 0.
    for j, case in pairs:
        table = ref.move_table(fields.thresholded(want[j.label][case]),
                               out.case_fields(j, case, device)[1], dirn)
        trans = ref.transitions(table, dirn, int(cfg['track_dirn_restrict']),
                                float(cfg['track_stochastic_nu']))
        del table
        want_sum = want_sum + ref.expected_counts(
            trans, hists[j.draw][None], int(min(shape) / 10),
            int(cfg['track_max_steps']))[0]
        del trans
        got_sum = got_sum + out.case_counts(j, case, device)
    if pairs:
        values['counts_l1'] = block_l1(got_sum, want_sum, COUNTS_BLOCK)
        values['counts_mass'] = abs(float(
            (got_sum.sum() - want_sum.sum()) / want_sum.sum()))
    else:
        values['counts_l1'] = values['counts_mass'] = inf
    if summary_job is None or summary_job.label in bad:
        values['summary_gap'] = inf
    else:
        counts = torch.stack([out.case_counts(summary_job, c, device)
                              for c in sorted(want[summary_job.label])])
        krad = ref.kernel_radius(1000., float(cfg['resolution']), shape)
        values['summary_gap'] = float((out.summary(summary_job, device)
                                       - ref.summary_map(counts, krad))
                                      .abs().max())
    return values


class PairSample:
    """:data:`COUNT_PAIRS` (job, case) pairs of a stream of jobs, each pair
    as likely as any other, and one job whose summary map is judged, each
    job as likely: drawn from the seed as the jobs come (reservoir
    sampling), so that the counts that no pair and no summary needs can go
    at once."""

    def __init__(self, seed: int):
        self._rng = random.Random(int(seed))
        self.kept = []
        self.summary_job = None
        self.seen = 0
        self.jobs = 0

    def add(self, job) -> list:
        """Offer ``job`` and its cases; returns ``(job, cases, summary)``
        for each job of which the sample now needs less: the cases whose
        counts may go, and whether its summary may."""
        touched = {job.label: job}
        self.jobs += 1
        if self._rng.randrange(self.jobs) == 0:
            if self.summary_job is not None:
                touched[self.summary_job.label] = self.summary_job
            self.summary_job = job
        for case in job.cases:
            self.seen += 1
            if len(self.kept) < COUNT_PAIRS:
                self.kept.append((job, case))
                continue
            slot = self._rng.randrange(self.seen)
            if slot < COUNT_PAIRS:
                touched[self.kept[slot][0].label] = self.kept[slot][0]
                self.kept[slot] = (job, case)
        out = []
        for j in touched.values():
            if j is not self.summary_job:
                need = {c for k, c in self.kept if k is j}
                out.append((j, [c for c in j.cases if c not in need], True))
        return out


def verdict(values: dict, limits: dict):
    """(correct, {name: {value, limit}})."""
    checks = {n: {'value': values[n], 'limit': limits[n]} for n in NAMES}
    return all(c['value'] <= c['limit'] for c in checks.values()), checks
