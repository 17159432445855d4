"""A frozen copy of the uniform judge's arithmetic as it stood before the
check learned to judge WTK runs by case: how the check read a uniform
run's outputs and the five numbers it worked out from them. The tests
hold the current judge's uniform numbers to it, bit for bit."""

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import reference as ref
from benchmark import terrain

COUNTS_BLOCK = 5


def case_id(speed, dirn):
    return f's{int(speed)}d{int(dirn)}'


def reference_fields(cfg, dem, dem_bounds, device):
    z = torch.as_tensor(terrain.reproject(dem, dem_bounds, cfg),
                        device=device)
    slope, aspect = ref.slope_aspect(z, float(cfg['resolution']))
    speed = float(cfg['uniform_windspeed'])
    dirns = cfg.get('wind_directions') or [cfg['uniform_winddirn']]
    return {case_id(speed, d): ref.threshold(
        ref.orograph(slope, aspect, speed, float(d)),
        float(cfg['updraft_threshold'])) for d in dirns}


def block_l1(got, want, block):
    pad = (0, -want.shape[-1] % block, 0, -want.shape[-2] % block)
    g = F.avg_pool2d(F.pad(got, pad)[None, None], block)[0, 0]
    w = F.avg_pool2d(F.pad(want, pad)[None, None], block)[0, 0]
    return float((g - w).abs().sum() / w.sum())


def starts(cfg, draws, tracks):
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


def _digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def numbers(cfg, ref_thr, field_outputs, count_jobs, tracks, device):
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
    trans, starts_g, case_of = [], [], []
    for case, thr in ref_thr.items():
        groups = {}
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


def outputs(gen, job, device, counts=True):
    """The job's outputs as the check read them."""
    from ssrs_tpu_torch.fields import get_above_threshold_speed

    def load(path, dtype=torch.float32):
        return torch.as_tensor(np.load(path), dtype=dtype, device=device)

    thr = float(gen.fields['updraft_threshold'])
    out = {
        'thresholded': {c: get_above_threshold_speed(
            load(job.orograph_path(c)), thr) for c in job.cases},
        'potential': {c: load(job.potential_path(c))
                      for c in job.cases}}
    if counts:
        out['counts'] = {c: load(job.counts_path(c), torch.float64)
                         for c in job.cases}
        out['summary'] = load(job.summary_path(), torch.float64)
    return out


def check_numbers(gen, cfg, jobs, sampled, device):
    """The numbers of the window's ``jobs`` and the ``sampled`` jobs, as
    the check worked them out."""
    ref_thr = reference_fields(cfg, gen.dem, gen.dem_bounds, device)
    field_jobs = jobs[-1:] if gen.shared else jobs
    field_outputs = []
    for j in field_jobs:
        o = outputs(gen, j, device, counts=False)
        field_outputs.append({'thresholded': o['thresholded'],
                              'potential': o['potential']})
    count_jobs = [([j.draw], outputs(gen, j, device))
                  for j in sorted(sampled, key=lambda j: j.start)]
    return numbers(cfg, ref_thr, field_outputs, count_jobs, gen.tracks,
                   device)
