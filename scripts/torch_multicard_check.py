#!/usr/bin/env python3
"""The port's multi-device layer on distinct cards against the same mesh
size on one card.

Run from the root of a checkout on a machine with two cards or more:

    python3 scripts/torch_multicard_check.py

With C visible cards it compares the mesh ``[cuda:0, ..., cuda:C-1]`` with
``[cuda:0] * C`` on the README's 500x600 region (``REGION``, the main run
of ``chip_smoke.py``: 100,000 tracks, potential from the refined solver
on cuda:0, offline: the terrain is the synthetic DEM):

- the counts-only ``Simulator`` run with ``mesh_devices=0`` (every card):
  its counts are the sum of ``shard_maps_compacting``'s shards on the
  distinct cards, and each shard is bit for bit the same shard on one card;
- ``simulate_presence_sharded`` (the per-step kernel) on both meshes: equal
  maps;
- ``simulate_presence_cases_compacting`` with C cases, one table, on
  ``devices=`` the distinct cards and on cuda:0 alone: every case equal;
- the row-sharded orograph on the distinct cards: bitwise the one-card
  orograph; the row-sharded solve of the run's field on both meshes:
  bitwise equal; the 460x460 hard field on the distinct cards within 0.05
  of the host direct solve.

Each comparison must hold or the script exits 1. It prints the cards'
names and power limits (``nvidia-smi``) and, last, one JSON line of the
wall seconds of each run on each mesh (each after a warm-up run of the
same call; the solves once each).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the README's run
REGION = dict(
    run_name='wy', southwest_lonlat=(-106.21, 42.78),
    region_width_km=(60., 50.), resolution=100., sim_mode='uniform',
    uniform_winddirn=270., uniform_windspeed=10., track_count=100_000,
    potential_solver='auto', track_max_steps=10_000, sim_seed=7)
HARD_SHAPE = (460, 460)
HARD_ERR_MAX = 0.05
RREL_MAX = 1e-5


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def timed(torch, fn):
    """(result, wall seconds) of ``fn()``, every card synchronized."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.perf_counter() - t0


def refuse_http() -> None:
    """A ``requests`` that refuses every request: the terrain chain ends at
    the synthetic DEM, the turbine fetch at None."""
    import types

    class ConnectionError(OSError):
        pass

    def get(*args, **kwargs):
        raise ConnectionError('torch_multicard_check.py runs offline')

    mod = types.ModuleType('requests')
    mod.get = get
    mod.exceptions = types.SimpleNamespace(
        ConnectionError=ConnectionError, ConnectTimeout=ConnectionError,
        HTTPError=ConnectionError)
    sys.modules['requests'] = mod


def run_starts(sim) -> np.ndarray:
    """The ``(N, 2)`` int32 start cells that a fresh ``Simulator`` like
    ``sim`` draws first."""
    from ssrs_tpu_torch.agents import get_starting_indices
    rows, cols = get_starting_indices(
        sim.track_count, list(sim.track_start_region), sim.track_start_type,
        tuple(sim.region_width_km), float(sim.resolution),
        rng=np.random.default_rng(sim.sim_seed))
    return np.stack([rows, cols], axis=1).astype(np.int32)


def sharded_solve(cond, dirn: float, mesh, tol: float = 1e-7):
    """(potential on the host, rrel, stats) of one row-sharded refined
    solve of ``cond`` over ``mesh``."""
    from ssrs_tpu_torch.parallel import solve_potential_refined_sharded
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    bmask, bvals = boundary_masks(dirn, tuple(cond.shape))
    stats = {}
    pot, rrel = solve_potential_refined_sharded(cond, bmask, bvals,
                                                mesh=mesh, tol=tol,
                                                stats=stats)
    return pot.gather().cpu().numpy(), rrel, stats


def main() -> int:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail('needs two CUDA devices or more')
    sys.path.insert(0, REPO)
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents.simulate import (
        field_table, simulate_presence_cases_compacting)
    from ssrs_tpu_torch.core.rng import case_seed
    from ssrs_tpu_torch.fields.updraft import orographic_updraft_from_dem
    from ssrs_tpu_torch.parallel import (orographic_updraft_from_dem_sharded,
                                         simulate_presence_sharded)
    from ssrs_tpu_torch.parallel.mesh import shard_maps_compacting
    from ssrs_tpu_torch.potential import solve_potential_direct
    from ssrs_tpu_torch.potential.fields import conductivity_hard

    cards = torch.cuda.device_count()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    distinct = [torch.device('cuda', i) for i in range(cards)]
    one = [torch.device('cuda', 0)] * cards
    meshes = {'distinct': distinct, 'one_card': one}
    refuse_http()
    secs = {}
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        cfg = Config(out_dir=out, **REGION)
        sim = Simulator(cfg)
        if sim.mesh != tuple(distinct):
            fail(f'the default mesh is {sim.mesh}, not every card')
        _, secs['simulator_distinct'] = timed(torch, sim.simulate_tracks)
        rec = {r['phase']: r for r in sim.timer.records}
        case = sim.case_ids[0]
        ident = sim._get_id_string(case, 0)
        counts = np.load(os.path.join(sim.mode_data_dir,
                                      f'{ident}_counts.npy'))
        params = sim._track_params()
        starts = run_starts(sim)
        seed = case_seed(sim.sim_seed, case, 0, 'tracks')
        updraft = sim.load_updrafts(case)[0]
        potential = torch.from_numpy(np.load(os.path.join(
            sim.mode_data_dir, f'{ident}_potential.npy'))).cuda(0)

        maps = {}
        for name, mesh in meshes.items():
            shard_maps_compacting(params, starts, seed, updraft, potential,
                                  mesh)
            maps[name], secs[f'compacting_{name}'] = timed(
                torch, lambda: shard_maps_compacting(
                    params, starts, seed, updraft, potential, mesh))
        if not torch.equal(maps['distinct'][0], maps['one_card'][0]) or \
                not np.array_equal(maps['distinct'][1], maps['one_card'][1]):
            fail('the shards on distinct cards differ from those on one')
        if not np.array_equal(maps['distinct'][0].sum(
                0, dtype=torch.int32).cpu().numpy(), counts):
            fail('the Simulator\'s counts are not the sum of its shards')
        print(f'compacting: {cards} shards on {cards} cards bit for bit the '
              f'shards on one card; Simulator tracks phase '
              f'{rec["tracks"]["seconds"]:.3f} s (devices '
              f'{rec["tracks"]["devices"]})', flush=True)

        plain = {}
        for name, mesh in meshes.items():
            plain[name], secs[f'plain_{name}'] = timed(
                torch, lambda: simulate_presence_sharded(
                    params, starts, seed, updraft=updraft,
                    potential=potential, mesh=mesh))
        if not torch.equal(plain['distinct'][0], plain['one_card'][0]):
            fail('simulate_presence_sharded differs between the meshes')
        print('simulate_presence_sharded: equal maps on both meshes',
              flush=True)

        table = field_table(params, updraft, potential, distinct[0])
        cases = {}
        for name, devices in (('distinct', distinct), ('one_card', None)):
            gens = [torch.Generator(device=distinct[i] if devices else
                                    distinct[0]).manual_seed(i)
                    for i in range(cards)]
            cases[name], secs[f'cases_{name}'] = timed(
                torch, lambda: simulate_presence_cases_compacting(
                    params, [table] * cards, starts, gens, devices=devices))
        if not torch.equal(cases['distinct'][0], cases['one_card'][0]):
            fail('the cases driver differs with devices= distinct cards')
        print(f'cases driver: {cards} cases over {cards} cards equal to '
              'one card', flush=True)

        z = sim.get_terrain_elevation().astype(np.float32)
        wind = [torch.tensor(float(v), device=distinct[0]) for v in
                (sim.uniform_windspeed, sim.uniform_winddirn)]
        want = orographic_updraft_from_dem(torch.from_numpy(z).cuda(0),
                                           sim.resolution, *wind)
        oro = orographic_updraft_from_dem_sharded(
            z, sim.resolution, sim.uniform_windspeed, sim.uniform_winddirn,
            mesh=distinct).gather()
        if not torch.equal(oro, want):
            fail('the orograph on distinct cards differs from one card\'s')

        solves = {}
        for name, mesh in meshes.items():
            (solves[name], secs[f'solve_{name}']) = timed(
                torch, lambda: sharded_solve(
                    updraft, float(sim.track_direction), mesh,
                    sim.potential_tol))
        if not np.array_equal(solves['distinct'][0], solves['one_card'][0]):
            fail('the sharded solve differs between the meshes')
        hard = conductivity_hard(HARD_SHAPE, seed=1)
        (h_pot, h_rrel, h_stats), secs['hard_distinct'] = timed(
            torch, lambda: sharded_solve(torch.from_numpy(hard).cuda(0), 0.,
                                         distinct))
        h_err = float(np.abs(h_pot.astype(np.float64) -
                             solve_potential_direct(hard, 0.)).max())
        if not (h_err < HARD_ERR_MAX and h_rrel < RREL_MAX):
            fail(f'hard field on distinct cards: err {h_err}, rrel {h_rrel}')
        print(f'orograph bitwise; sharded solve of the main field bitwise '
              f'equal on both meshes (rrel {solves["distinct"][1]:.3e}, '
              f'{solves["distinct"][2]["vcycles"]} V-cycles); hard field '
              f'err {h_err:.4g}, {h_stats["vcycles"]} V-cycles', flush=True)
    print(json.dumps({'cards': cards,
                      'names': [torch.cuda.get_device_name(i)
                                for i in range(cards)],
                      'seconds': secs, 'hard_max_abs_err': h_err}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
