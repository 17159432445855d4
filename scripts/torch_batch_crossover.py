#!/usr/bin/env python3
"""Batched against single refined solves on the card: where does a batch
of cases pay?

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_batch_crossover.py [--grids 500x600,800x600,...]
        [--groups 1,2,4,8] [--reps 2] [--out output/batch_crossover.json]

The counterpart of ``scripts/exp_batch_crossover.py``. For each grid it
builds eight thresholded orographic updrafts, one a wind direction (0,
45, ..., 315 degrees at 10 m/s, track direction 0), of a region the repo
runs (offline: the synthetic DEM): the README's region at 500x600
(100 m), Altamont Pass at 800x600 (``examples/example_altamontpass.py``)
and the JEM region at 1000x1000 (50 m, ``examples/example_jem.py``).
Then it solves the eight fields in groups of each size: a group of 1 is
the single solve (``solve_potential_refined``), a larger one the batched
solve (``solve_potential_refined_batch``). After one warm-up of a single
and a batched solve, the group sizes run in turns (1, 2, 4, 8, 8, 4, 2,
1 for two repetitions). For each grid and group size it prints the
seconds to solve all eight fields (each repetition), the V-cycles and
rrel of every case, the largest difference from the single solve's
potential, and the peak device memory of one group above what was
allocated before it (``torch.cuda.max_memory_allocated``), also per cell
and case. It prints the card's name and power limit first, and writes
everything to ``--out`` as JSON. It exits 1 if any case of a batch has
an rrel above 5e-3 (the Simulator's net) where its single solve has not.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import types


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECTIONS = (0., 45., 90., 135., 180., 225., 270., 315.)
REGIONS = {
    # the README's region (README.md, "Usage")
    '500x600': dict(southwest_lonlat=(-106.21, 42.78),
                    region_width_km=(60., 50.), resolution=100.),
    # examples/example_altamontpass.py:17-26
    '800x600': dict(southwest_lonlat=(-121.98, 37.56),
                    region_width_km=(60., 80.), resolution=100.),
    # examples/example_jem.py:16-25
    '1000x1000': dict(southwest_lonlat=(-106.21, 42.78),
                      region_width_km=(50., 50.), resolution=50.),
}
NET = 5e-3


def _refuse_http():
    """A ``requests`` that refuses every request: the terrain chain ends at
    the synthetic DEM and the turbine fetch at None, with or without a
    network."""
    class ConnectionError(OSError):
        pass

    def get(*args, **kwargs):
        raise ConnectionError('torch_batch_crossover.py runs offline')

    mod = types.ModuleType('requests')
    mod.get = get
    mod.exceptions = types.SimpleNamespace(
        ConnectionError=ConnectionError, ConnectTimeout=ConnectionError,
        HTTPError=ConnectionError)
    sys.modules['requests'] = mod


def sweep_fields(torch, grid: str, out_dir: str):
    """The eight thresholded updrafts of ``grid``'s region on the card, as
    ``Simulator.simulate_direction_sweep`` makes them."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.fields import get_above_threshold_speed
    sim = Simulator(Config(
        run_name=f'crossover_{grid}', out_dir=out_dir, sim_mode='uniform',
        uniform_windspeed=10., track_direction=0., track_count=10,
        **REGIONS[grid]))
    if 'x'.join(map(str, sim.gridsize)) != grid:
        raise RuntimeError(f'{grid}: the region is {sim.gridsize}')
    slope, aspect = sim._slope_aspect()
    return [get_above_threshold_speed(sim._orograph(slope, aspect, d),
                                      sim.updraft_threshold)
            for d in DIRECTIONS]


def solve_groups(torch, fields, size: int):
    """All fields solved in groups of ``size``: (seconds, potentials,
    rrels, stats per case, peak bytes of one group above its start)."""
    from ssrs_tpu_torch.potential import (boundary_masks,
                                          solve_potential_refined,
                                          solve_potential_refined_batch)
    bmask, bvals = boundary_masks(0., tuple(fields[0].shape))
    pots, rrels, vcycles, passes, peak = [], [], [], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g0 in range(0, len(fields), size):
        group = fields[g0:g0 + size]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        if size == 1:
            pot, rrel = solve_potential_refined(group[0], bmask, bvals,
                                                stats=stats)
            pots.append(pot)
            rrels.append(rrel)
            stats = {k: [v] for k, v in stats.items()}
        else:
            batch, rr = solve_potential_refined_batch(
                torch.stack(group), bmask, bvals, stats=stats)
            pots.extend(batch)
            rrels.extend(float(r) for r in rr)
        vcycles.extend(stats['vcycles'])
        passes.extend(stats['passes'])
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, pots, rrels,
            {'vcycles': vcycles, 'passes': passes}, peak)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--grids', default='500x600,800x600,1000x1000')
    ap.add_argument('--groups', default='1,2,4,8')
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--out',
                    default=os.path.join('output', 'batch_crossover.json'))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    _refuse_http()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sizes = [int(g) for g in args.groups.split(',')]
    order = (sizes + sizes[::-1]) * ((args.reps + 1) // 2)
    results, bad = {'card': card, 'grids': {}}, []
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.crossover_') as tmp:
        for grid in args.grids.split(','):
            fields = sweep_fields(torch, grid, tmp)
            cells = fields[0].numel()
            # warm-up: the allocator's pools and every kernel of both paths
            solve_groups(torch, fields[:1], 1)
            solve_groups(torch, fields[:2], 2)
            runs = {g: [] for g in sizes}
            for g in order[:len(sizes) * args.reps]:
                runs[g].append(solve_groups(torch, fields, g))
            solo = runs[1][0][1]
            rows = {}
            for g in sizes:
                secs = [r[0] for r in runs[g]]
                _, pots, rrels, stats, peak = runs[g][0]
                diff = max(float((p - s).abs().max())
                           for p, s in zip(pots, solo))
                rows[g] = {'seconds': secs, 'rrel': rrels, **stats,
                           'max_abs_vs_single': diff, 'peak_bytes': peak,
                           'peak_bytes_per_cell_case':
                               peak / (min(g, len(fields)) * cells)}
                bad += [f'{grid} group {g} case {i}: rrel {r:.3e}'
                        for i, r in enumerate(rrels)
                        if r > NET and runs[1][0][2][i] <= NET]
                print(f'{grid} group {g}: {", ".join(f"{s:.3f}" for s in secs)}'
                      f' s for {len(fields)} fields; V-cycles '
                      f'{stats["vcycles"]}; rrel '
                      f'{", ".join(f"{r:.2e}" for r in rrels)}; max |d| vs '
                      f'single {diff:.4g}; peak {peak / 2**20:.1f} MiB = '
                      f'{rows[g]["peak_bytes_per_cell_case"]:.0f} B a cell '
                      'and case', flush=True)
            results['grids'][grid] = rows
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w', encoding='utf-8') as fobj:
        json.dump(results, fobj, indent=1)
    print(json.dumps({g: {k: min(v['seconds']) for k, v in rows.items()}
                      for g, rows in results['grids'].items()}), flush=True)
    for line in bad:
        print(f'FAIL: {line}', file=sys.stderr)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
