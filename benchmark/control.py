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


def window_draws(seed: int, count: int) -> list:
    """The start draws of ``count`` window jobs of a run with ``seed``."""
    from .traffic import job_seed
    return [(job_seed(seed, k), 0) for k in range(count)]


def readings(root: str, cell_name: str, seeds, device,
             table_only: bool = False, jobs=None) -> list:
    """The control's numbers of ``cell_name`` on each seed, over the
    starts of ``jobs`` window jobs (by default :data:`judge.COUNT_JOBS`;
    give fewer where a run's window holds fewer)."""
    from . import cells, judge, terrain
    spec = cells.load_spec(root)
    cell = cells.find_cell(spec, cell_name)
    cfg = cells.load_config(root, spec, cell['config'])
    mix = cells.load_traffic(root, cell['traffic'])
    dem, bnds = terrain.make_dem(cfg)
    ref_thr = judge.reference_fields(cfg, dem, bnds, device)
    tracks = int(mix['tracks_per_case'])
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
