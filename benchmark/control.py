"""The control: the plain reference put in the program's place and
computed one precision below the configuration's, judged as the
program's outputs are.

The configuration computes its fields and potentials in float32 and
stores the move table in bfloat16 (``track_weight_precision='auto'`` at
500x600). The control computes the DEM, slope, aspect, orographic and
thresholded updraft in bfloat16; takes the float64 direct solution of its
own system rounded to bfloat16 (the closest a bfloat16 solve can come);
stores its move table in float8 (e4m3, a scale a row); walks the
tracks of :data:`judge.COUNT_JOBS` jobs' start draws with it; and
smooths and normalizes the summary map in bfloat16.

With ``table_only`` only the move table and the walk are the control's:
the fields are the reference's in float32, the potentials its float64
direct solutions, the summary map float64, so that only the counts can
tell it from the program.

A snapshot or seasonal configuration takes the same path by case
(:class:`WtkControl`): the reference's interpolated winds rounded to
bfloat16 and the orograph in bfloat16, the datetimes and starts of the
window's job seeds, each (job, case) pair the judge draws walked on its
own; it is judged by ``judge.wtk_numbers``, its fields and potentials on
the drawn pairs alone (a float64 direct solve a case costs too much for
every case of a job).

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--table-only]

prints one JSON line a seed with the control's numbers, beside the cell's
limits. Run it on the card, at the cell's size; the benchmark's runs do
not run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

BF16 = torch.bfloat16


def fp8_table(table: torch.Tensor) -> torch.Tensor:
    """The weights rounded to float8 e4m3 with one scale a cell (its
    largest weight to 448), back in float32."""
    t = table.to(torch.float32)
    scale = t.amax(-1, keepdim=True).clamp(min=1e-30) / 448.
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def control_outputs(cfg: dict, dem, dem_bounds, draws, tracks: int,
                    seed: int, device, potentials=None,
                    table_only: bool = False):
    """The control's outputs of one pseudo-job that walks every start of
    ``draws``: as ``Traffic.outputs``. ``potentials``, {case: float64
    solution}, saves the direct solves between seeds (they do not depend
    on the seed)."""
    from . import judge, reference as ref, terrain
    low = torch.float64 if table_only else BF16
    z = torch.as_tensor(terrain.reproject(dem, dem_bounds, cfg),
                        device=device).to(low)
    slope, aspect = ref.slope_aspect(z, float(cfg['resolution']))
    speed = float(cfg['uniform_windspeed'])
    dirn = float(cfg['track_direction'])
    thr = {}
    for d in cfg.get('wind_directions') or [cfg['uniform_winddirn']]:
        oro = ref.orograph(slope, aspect, speed, float(d))
        thr[judge.case_id(speed, d)] = ref.threshold(
            oro, float(cfg['updraft_threshold'])).to(torch.float32)
    if potentials is None:
        potentials = {}
    pot = {}
    for case, t in thr.items():
        if case not in potentials:
            potentials[case] = ref.direct_potential(
                t.double().cpu().numpy(), dirn)
        pot[case] = torch.as_tensor(potentials[case], device=device)
        if not table_only:
            pot[case] = pot[case].to(BF16).to(torch.float32)
    rows, cols = zip(*judge.starts(cfg, draws, tracks))
    import numpy as np
    starts_rc = torch.as_tensor(np.stack(
        [np.concatenate(rows), np.concatenate(cols)], 1), device=device)
    cases = list(thr)
    tables = torch.stack([fp8_table(ref.move_table(thr[c], pot[c], dirn))
                          for c in cases])
    shape = tables.shape[1:3]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    counts = ref.walk_counts(
        tables, starts_rc, dirn, int(cfg['track_dirn_restrict']),
        float(cfg['track_stochastic_nu']), int(min(shape) / 10),
        int(cfg['track_max_steps']), gen)
    krad = ref.kernel_radius(1000., float(cfg['resolution']), shape)
    summary = ref.summary_map(counts.to(low), krad, dtype=low).to(
        torch.float64)
    return {'thresholded': thr, 'potential': pot,
            'counts': dict(zip(cases, counts)), 'summary': summary}


class _Job:
    """A pseudo-job of the control: a window job's label, seed, start
    draw and the reference's case ids of that seed."""

    def __init__(self, cfg: dict, seed: int, label):
        from . import wtkref
        from .traffic import job_seed
        self.label = label
        self.seed = job_seed(seed, label)
        self.draw = (self.seed, 0)
        self.datetimes = wtkref.cases(cfg, self.seed)
        self.cases = list(self.datetimes)


class WtkControl:
    """The control's outputs of a snapshot or seasonal configuration, read
    as ``Traffic``'s are (``case_fields``, ``case_counts``, ``summary``)
    and made as they are first read. ``potentials``, {case: float64
    solution}, saves the direct solves between seeds (a case's solution
    does not depend on the seed)."""

    def __init__(self, cfg: dict, dem, dem_bounds, tracks: int, seed: int,
                 device, potentials=None, table_only: bool = False):
        from . import wtkref
        self.cfg, self.tracks, self.device = cfg, tracks, device
        self.low = torch.float64 if table_only else BF16
        self.table_only = table_only
        self.fields = wtkref.Fields(cfg, dem, dem_bounds, device,
                                    dtype=self.low)
        self.potentials = {} if potentials is None else potentials
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self._fields, self._counts = {}, {}

    def case_fields(self, job, case: str, device):
        from . import reference as ref
        key = (job.label, case)
        if key not in self._fields:
            thr = self.fields.thresholded(job.datetimes[case]).to(
                torch.float32)
            if case not in self.potentials:
                self.potentials[case] = ref.direct_potential(
                    thr.double().cpu().numpy(),
                    float(self.cfg['track_direction']))
            pot = torch.as_tensor(self.potentials[case], device=self.device)
            if not self.table_only:
                pot = pot.to(BF16).to(torch.float32)
            self._fields[key] = (thr, pot)
        return self._fields[key]

    def case_counts(self, job, case: str, device):
        from . import judge, reference as ref
        key = (job.label, case)
        if key not in self._counts:
            import numpy as np
            cfg = self.cfg
            dirn = float(cfg['track_direction'])
            thr, pot = self.case_fields(job, case, device)
            rows, cols = judge.starts(cfg, [job.draw], self.tracks)[0]
            starts_rc = torch.as_tensor(np.stack([rows, cols], 1),
                                        device=self.device)
            table = fp8_table(ref.move_table(thr, pot, dirn))[None]
            shape = table.shape[1:3]
            self._counts[key] = ref.walk_counts(
                table, starts_rc, dirn, int(cfg['track_dirn_restrict']),
                float(cfg['track_stochastic_nu']), int(min(shape) / 10),
                int(cfg['track_max_steps']), self.gen)[0]
        return self._counts[key]

    def summary(self, job, device):
        from . import reference as ref
        counts = torch.stack([self.case_counts(job, c, device)
                              for c in sorted(job.cases)])
        krad = ref.kernel_radius(1000., float(self.cfg['resolution']),
                                 counts.shape[1:])
        return ref.summary_map(counts.to(self.low), krad,
                               dtype=self.low).to(torch.float64)


def wtk_readings(cfg: dict, dem, bnds, tracks: int, seeds, device,
                 table_only: bool = False, jobs=None) -> list:
    """The control's numbers of a snapshot or seasonal configuration on
    each seed, over ``jobs`` window jobs (by default one)."""
    from . import judge, wtkref
    ref_fields = wtkref.Fields(cfg, dem, bnds, device)
    solved = {}
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctl = WtkControl(cfg, dem, bnds, tracks, seed, device, solved,
                         table_only)
        sample = judge.PairSample(seed)
        for k in range(jobs or 1):
            sample.add(_Job(cfg, seed, k))
        values = judge.wtk_numbers(cfg, ref_fields, ctl, sample.kept,
                                   sample.kept, sample.summary_job, tracks,
                                   device)
        out.append({'seed': seed, 'numbers': values,
                    'seconds': time.perf_counter() - t0})
    return out


def window_draws(seed: int, count: int) -> list:
    """The start draws of ``count`` window jobs of a run with ``seed``."""
    from .traffic import job_seed
    return [(job_seed(seed, k), 0) for k in range(count)]


def readings(root: str, cell_name: str, seeds, device,
             table_only: bool = False, jobs=None) -> list:
    """The control's numbers of ``cell_name`` on each seed, over the
    starts of ``jobs`` window jobs (by default :data:`judge.COUNT_JOBS`,
    or one for a snapshot or seasonal configuration; give fewer where a
    run's window holds fewer)."""
    from . import cells, judge, terrain, wtkref
    spec = cells.load_spec(root)
    cell = cells.find_cell(spec, cell_name)
    cfg = cells.load_config(root, spec, cell['config'])
    mix = cells.load_traffic(root, cell['traffic'])
    dem, bnds = terrain.make_dem(cfg)
    tracks = int(mix['tracks_per_case'])
    if wtkref.is_wtk(cfg):
        return wtk_readings(cfg, dem, bnds, tracks, seeds, device,
                            table_only, jobs)
    ref_thr = judge.reference_fields(cfg, dem, bnds, device)
    solved = {}
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        draws = window_draws(seed, jobs or judge.COUNT_JOBS)
        o = control_outputs(cfg, dem, bnds, draws, tracks, seed, device,
                            solved, table_only)
        values = judge.numbers(cfg, ref_thr, [o], [(draws, o)], tracks,
                               device)
        out.append({'seed': seed, 'numbers': values,
                    'seconds': time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='the control readings')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--jobs', type=int, default=None,
                        help='the window jobs whose starts are walked')
    parser.add_argument('--table-only', action='store_true',
                        help='the reference\'s fields and potentials, the '
                        'control\'s table and walk')
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from benchmark import cells, control
    limits = cells.load_limits(root, args.workload)
    if not torch.cuda.is_available():
        print('the control runs on a CUDA device', file=sys.stderr)
        return 2
    for r in control.readings(root, args.workload, args.seeds, 'cuda:0',
                              args.table_only, args.jobs):
        r['limits'] = {k: limits[k] for k in r['numbers']}
        print(json.dumps(r), flush=True)
    return 0


if __name__ == '__main__':
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
