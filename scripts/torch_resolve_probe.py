#!/usr/bin/env python3
"""How the refined solve ends on seasonal WTK fields, and what a second
solve of a case that ends above its tolerance gives.

Run from the root of a checkout (on the card by default):

    python3 scripts/torch_resolve_probe.py [--jobs 16] [--seed 1] \
        [--config benchmark/configs/app_seasonal.json] \
        [--cut KM_X KM_Y RES] [--device cuda:0] [--direct 2] \
        [--out output/resolve_probe.json] [--save-fields 8]

Each job is a ``Simulator`` of the configuration (a seasonal one with
``wtk_standin``: the benchmark's WTK stand-in is written once and read
as the ``LOCAL`` source), seeded as the benchmark seeds its jobs; its
thresholded updrafts are solved as the ``Simulator`` solves them, one
batch of ``potential_batch`` cases (``solve_potential_refined_batch``).
Every case whose rrel ends above ``potential_tol`` is then solved again
by each candidate:

- ``warm`` (history depth 3, 6, 10, 20): the single refined solve
  from the stalled iterate (``init=``), with a fresh GCR history, pass
  budget and stall count, and ``k`` GCR directions kept;
- ``cold`` (depth 3, 10): the single refined solve from the cold start;
- ``batch_warm`` (depth 3, 10), ``batch_cold`` (depth 10): the job's
  stalled cases together, one batch, from their stalled iterates or the
  cold start.

Every solution is held to the float64 interior residual of the
benchmark's judge (``benchmark/reference.py::interior_residual``), and
``--direct N`` cases also to the host float64 direct solve. The script
prints one JSON line a case and writes them all, with the card's name
and power limit, to ``--out``; the first ``--save-fields`` stalled
fields go beside it (``.npz``). ``--cut`` shrinks the region (and
``track_start_region``) for a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _card() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'no card'


def _sync(device) -> None:
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _timed(device, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def job_fields(gen, label):
    """(case ids, thresholded updrafts (C, nrow, ncol) on the device) of
    one job's ``Simulator``."""
    import torch
    from benchmark.traffic import job_seed
    with gen._quiet():
        sim = gen._simulator(f'job{label}', job_seed(gen.seed, label))
        fields = [sim.load_updrafts(c)[0] for c in sim.case_ids]
    return list(sim.case_ids), torch.stack(fields)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--jobs', type=int, default=16)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--config', default=os.path.join(
        REPO, 'benchmark', 'configs', 'app_seasonal.json'))
    parser.add_argument('--cut', type=float, nargs=3, default=None)
    parser.add_argument('--device', default='cuda:0')
    parser.add_argument('--direct', type=int, default=0)
    parser.add_argument('--out', default=os.path.join(
        REPO, 'output', 'resolve_probe.json'))
    parser.add_argument('--save-fields', type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from benchmark import offline, reference as ref, terrain
    from benchmark.traffic import Traffic
    from ssrs_tpu_torch.potential import lap
    from ssrs_tpu_torch.potential.boundary import boundary_masks

    offline.refuse_http()
    with open(args.config, encoding='utf-8') as f:
        cfg = json.load(f)
    if args.cut:
        kx, ky, res = args.cut
        cfg.update(region_width_km=[kx, ky], resolution=res,
                   track_start_region=[1., kx - 1., 0., 1.])
    tol = float(cfg['potential_tol'])
    dirn = float(cfg['track_direction'])
    work = tempfile.mkdtemp(prefix='resolve_probe_')
    gen = Traffic(cfg, {'tracks_per_case': 1000, 'share_potentials': False},
                  args.seed, work, args.device)
    gen.dem, gen.dem_bounds = terrain.make_dem(gen.fields)
    os.makedirs(os.path.join(work, 'raster'))
    gen.raster = os.path.join(work, 'raster', 'srtm1.tif')
    terrain.write_dem_tiff(gen.raster, gen.dem, gen.dem_bounds)
    gen._write_standin()

    rows, saved = [], {}
    direct_left = args.direct

    def resid(pot, cond):
        return ref.interior_residual(pot, cond, dirn)

    def solve(conds, inits, k):
        """The refined solve of a (C, nrow, ncol) batch (C = 1: the single
        solve) from ``inits`` (None: the cold start) with ``k`` GCR
        directions: (potentials, one dict of numbers a case)."""
        stats = {}
        if conds.shape[0] == 1:
            (pot, rrel), secs = _timed(args.device, lambda: (
                lap.solve_potential_refined(
                    conds[0], bmask, bvals, tol=tol, maxcycles=60,
                    init=None if inits is None else inits[0], stats=stats,
                    depth=k)))
            pots, rrels = pot[None], [rrel]
            stats = {key: [v] for key, v in stats.items()}
        else:
            (pots, rrels), secs = _timed(args.device, lambda: (
                lap.solve_potential_refined_batch(
                    conds, bmask, bvals, tol=tol, maxcycles=60, stats=stats,
                    init=inits, depth=k)))
        return pots, [{'rrel': float(rrels[j]), 'seconds': secs,
                       'batch': int(conds.shape[0]),
                       'passes': int(stats['passes'][j]),
                       'vcycles': int(stats['vcycles'][j]),
                       'resid': resid(pots[j], conds[j])}
                      for j in range(conds.shape[0])]

    try:
        for label in range(args.jobs):
            cases, conds = job_fields(gen, label)
            shape = tuple(conds.shape[-2:])
            bmask, bvals = boundary_masks(dirn, shape)
            stats = {}
            (pots, rrels), secs = _timed(args.device, lambda: (
                lap.solve_potential_refined_batch(
                    conds, bmask, bvals, tol=tol, maxcycles=60,
                    stats=stats)))
            print(f'job {label}: batch of {len(cases)} in {secs:.2f} s, '
                  f'rrel {[f"{r:.1e}" for r in rrels]}', flush=True)
            stalled = [i for i, r in enumerate(rrels) if r > tol]
            mine = []
            for i, case in enumerate(cases):
                mine.append({'job': label, 'case': case, 'shape': shape,
                             'first': {'rrel': float(rrels[i]),
                                       'seconds': secs, 'batch': len(cases),
                                       'vcycles': int(stats['vcycles'][i]),
                                       'passes': int(stats['passes'][i]),
                                       'resid': resid(pots[i], conds[i])}})
            for i in stalled:
                row, one = mine[i], conds[i:i + 1]
                for k in (3, 6, 10, 20):
                    row[f'warm_k{k}'] = solve(one, pots[i:i + 1], k)[1][0]
                for k in (3, 10):
                    row[f'cold_k{k}'] = solve(one, None, k)[1][0]
                if len(saved) < args.save_fields:
                    saved[f'j{label}_{cases[i]}'] = \
                        conds[i].cpu().numpy()
                if direct_left > 0:
                    direct_left -= 1
                    x, dsecs = _timed('cpu', lambda: ref.direct_potential(
                        conds[i].double().cpu().numpy(), dirn))
                    xt = torch.as_tensor(x, device=args.device)
                    row['direct'] = {
                        'seconds': dsecs, 'resid': resid(xt, conds[i]),
                        'first_maxdiff': float((pots[i].double() - xt)
                                               .abs().max())}
            if len(stalled) > 1:
                sub, init = conds[stalled], pots[stalled]
                for name, inits, k in (('batch_warm_k3', init, 3),
                                       ('batch_warm_k10', init, 10),
                                       ('batch_cold_k10', None, 10)):
                    for i, res in zip(stalled, solve(sub, inits, k)[1]):
                        mine[i][name] = res
            for row in mine:
                print(json.dumps(row), flush=True)
            rows.extend(mine)
    finally:
        gen.close()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w', encoding='utf-8') as f:
        json.dump({'card': _card(), 'seed': args.seed, 'jobs': args.jobs,
                   'rows': rows}, f)
    if saved:
        np.savez_compressed(os.path.splitext(args.out)[0] + '.npz', **saved)
    print(json.dumps({'card': _card(), 'cases': len(rows), 'stalled': sum(
        'cold_k3' in r for r in rows)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
