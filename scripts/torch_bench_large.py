"""Large-grid smoke benchmark of ssrs_tpu_torch on one CUDA card: the
port's counterpart of ``scripts/bench_large.py`` (BASELINE.json config 5:
200x200 km at 30 m, a 6667x6667 grid of 44.4M cells, 100k tracks).

The same calls in torch: a synthetic DEM at 30 m, the orographic updraft
and its threshold, ``solve_potential_refined`` with ``maxcycles=60``, then
``simulate_presence_compacting`` for 100,000 tracks (chunks of 128 steps,
the ``'auto'`` tail, a bfloat16 table). ``SSRS_LARGE_N`` sets the grid's
side (default 6667) and ``SSRS_LARGE_STEPS`` the step cap (default 2000);
``SSRS_LARGE_SHARDS=n`` (n > 1) solves instead through the row-sharded
solver over ``[cuda:0] * n`` (``parallel.solve_potential_refined_sharded``).

    python3 scripts/torch_bench_large.py
    SSRS_LARGE_N=8192 python3 scripts/torch_bench_large.py
    SSRS_LARGE_N=8192 SSRS_LARGE_SHARDS=4 python3 scripts/torch_bench_large.py

Prints one JSON line: ``bench_large.py``'s keys, plus ``shards``,
``vcycles``, ``passes``, ``peak_gb`` (the largest of the phases' peak
device memory,
each phase's in ``peak_gb_by_phase``) and ``device`` (the card's name and
power limit). Without a CUDA device it exits non-zero and prints no
result. It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch


def synthetic_dem(nrow, ncol, res):
    """Deterministic ridge-and-valley terrain, WY-like relief (~1 km): the
    DEM of ``bench.py``."""
    y = np.linspace(0, 1, nrow)[:, None]
    x = np.linspace(0, 1, ncol)[None, :]
    z = (500 * np.sin(2 * np.pi * 3.5 * x) * np.cos(2 * np.pi * 2.5 * y)
         + 300 * np.sin(2 * np.pi * 7 * x + 1.3)
         + 200 * np.cos(2 * np.pi * 5 * y + 0.4)
         + 2000)
    return z.astype(np.float32)


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_bench_large.py: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ssrs_tpu_torch.agents import (TrackParams, get_starting_indices,
                                       simulate_presence_compacting)
    from ssrs_tpu_torch.fields import (get_above_threshold_speed,
                                       orographic_updraft_from_dem)
    from ssrs_tpu_torch.potential import solve_potential_refined
    from ssrs_tpu_torch.potential.boundary import boundary_masks

    dev = torch.device('cuda', 0)
    nrow = ncol = int(os.environ.get('SSRS_LARGE_N', 6667))
    res = 30.0
    n_tracks = 100_000
    step_cap = int(os.environ.get('SSRS_LARGE_STEPS', 2000))
    shards = int(os.environ.get('SSRS_LARGE_SHARDS', 1))
    peaks = {}

    def reset():
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def peak(name):
        torch.cuda.synchronize(dev)
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 1e9

    dem = torch.from_numpy(synthetic_dem(nrow, ncol, res)).to(dev)
    reset()
    t0 = time.perf_counter()
    w = orographic_updraft_from_dem(
        dem, res, torch.full((nrow, ncol), 10., device=dev),
        torch.full((nrow, ncol), 270., device=dev))
    conductivity = get_above_threshold_speed(w, 0.75)
    torch.cuda.synchronize(dev)
    dt_updraft = time.perf_counter() - t0
    del w, dem
    peak('updraft')
    print(f'updraft {dt_updraft:.2f}s', flush=True)

    reset()
    t0 = time.perf_counter()
    bmask, bvals = boundary_masks(0., (nrow, ncol))
    stats = {}
    if shards > 1:
        from ssrs_tpu_torch.parallel import solve_potential_refined_sharded
        pot, resid = solve_potential_refined_sharded(
            conductivity, bmask, bvals, mesh=[dev] * shards, maxcycles=60,
            stats=stats)
        pot = pot.gather()
    else:
        pot, resid = solve_potential_refined(conductivity, bmask, bvals,
                                             maxcycles=60, stats=stats)
    torch.cuda.synchronize(dev)
    dt_potential = time.perf_counter() - t0
    peak('potential')
    finite = bool(torch.isfinite(pot).all())
    print(f'potential {dt_potential:.2f}s resid {float(resid):.4g} '
          f'{stats["vcycles"]} V-cycles {stats["passes"]} passes',
          flush=True)

    width_km = ncol * res / 1000.
    rows, cols = get_starting_indices(
        n_tracks, [2., width_km - 2., 1., 2.], 'random',
        (width_km, nrow * res / 1000.), res,
        rng=np.random.default_rng(0))
    starts = np.stack([rows, cols], axis=1).astype(np.int32)
    params = TrackParams(grid_shape=(nrow, ncol), move_dirn=0., nu=1.,
                         memory_k=1, burnin=int(min(nrow, ncol) / 10),
                         nsteps=step_cap, weight_dtype='bfloat16')
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    reset()
    t0 = time.perf_counter()
    presence, steps = simulate_presence_compacting(
        params, starts, gen, updraft=conductivity, potential=pot, chunk=128,
        tail_bucket='auto')
    presence_np = presence.cpu().numpy()
    dt_sim = time.perf_counter() - t0
    peak('tracks')
    total = int(presence_np.astype(np.int64).sum())

    print(json.dumps({
        'metric': 'large_scale_smoke',
        'grid': [nrow, ncol],
        'cells': nrow * ncol,
        'updraft_seconds': round(dt_updraft, 2),
        'potential_seconds': round(dt_potential, 2),
        'potential_residual': float(resid),
        'potential_finite': finite,
        'shards': shards,
        'sim_seconds_incl_compile': round(dt_sim, 2),
        'agent_steps': total - n_tracks,
        'steps_taken': int(steps),
        'vcycles': int(stats['vcycles']),
        'passes': int(stats['passes']),
        'peak_gb': round(max(peaks.values()), 3),
        'peak_gb_by_phase': {k: round(v, 3) for k, v in peaks.items()},
        'device': _card(),
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
