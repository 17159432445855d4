#!/usr/bin/env python3
"""Smoke test of ssrs_tpu_torch on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (the
chunk kernel, which runs a chunk of agent steps per launch for the
compacting and the recording drivers; the fused agent step, which runs
one step per launch for ``simulate_presence``; and the presence
histograms: the flush of the delayed count, the weighted histogram that
no path runs, and the count of the recorded tracks' recount, in its
direct and its privatized kernel), checks nvcc's report (no stack frame
or spills in the chunk kernel, no spills in the flush and count
kernels), holds each kernel against its plain PyTorch version on the
card at the shapes its path gives it (the flush and the count also on
the paths' own inputs: the main field's state after one chunk, and the
recorded run's ``.pkl`` points; the count on one hot cell, on a grid of
twenty bands, and across numbers of points and grid sizes, where its
plan switches kernels; each timed in turns with the kernel it replaced),
and drives two runs of the README's region (500x600 cells at 100 m): the
uniform-mode run of 100,000 tracks with the default potential solver
(the refined solver, on the card), and the recorded-track run of 10,000
tracks (the default track_pkl_budget) on the cached potential, which
writes ``_tracks.pkl`` and must agree exactly with its own recount. On
every path each flush is one launch of the flush kernel. It
holds the main run's potential to the invariants of the reference's
system, solves it twice more on the card (bitwise equal, one solve
profiled), beside the host direct solve, and solves the 460x460 hard
field of tests/test_potential.py against the direct solve. On the main
run's own table and starts it holds one 512-step chunk launch against
512 per-step launches (exact, both timed in turns), times the chunk's
uniform draw, profiles a warm track phase and drives the per-step
driver. It checks small runs on the card, with and without recorded
tracks, against the same runs through the plain versions on the CPU.

The multi-case paths, all at the README region's width: both kernels
without a table (the directed random walk's branch) against their plain
versions; the thermal field's Gaussian filter, card against CPU, and
``compute_thermals`` on the run's aspect; the sweep of eight wind
directions with 100,000 tracks each through ``simulate_direction_sweep``
(two cases bit-identical to the single-case driver, launches counted,
the batched track phase again warm, timed and profiled; a rerun from
the potential cache); a run with two
thermal realizations through the batched driver, with device-resident
fields and through numpy (bitwise-equal artifacts); and a drw run
(no potential, a second run equal to the first).

The solver options, at the same width: the sweep again with its eight
potentials in one batched solve (``potential_batch=8``: each case
converged or fallen back, its interior residual, range and boundary, the
counts; a second batched solve bitwise equal; each case beside its single
solve of the sweep; the group's time, peak memory and the launches of
one batched V-cycle); the 460x460 hard field in a batch of four, within
0.05 of the direct solve; the legacy multigrid on the tests' and the hard
field and in a uniform run of 100,000 tracks (``potential_solver='mg'``);
and a uniform run with ``track_tail_bucket='auto'`` on the main run's
cached potential (its round trip, per-slot cost and last bucket, against
the main run's tail).

The WTK modes, at the same width, from a stand-in for the WindToolKit
archive that the script builds (an hourly 2-km grid of six layers for
2012: a real ``.h5`` where ``h5py`` imports, else an ``h5py``-shaped
module of its own; one line says which): a seasonal run of eight
timestamps with 100,000 tracks each through the ``LOCAL`` source and the
multi-case driver (the cases and starts of the seed, launches counted,
two cases bit-identical to the single-case driver, one orograph against
``device='cpu'`` on the same cached frame, a rerun that reads no dataset
of the source and takes every potential from the cache), and a snapshot
run with one thermal realization, 10,000 recorded tracks and a fixture of
turbines (``turbines.csv``, the counts against the recount of
``_tracks.pkl`` through the count kernel, ``get_turbine_presence``). The
script registers a ``requests`` of its own that refuses every request, so
every run is offline: the terrain is the synthetic DEM.

The command line, ``python -m ssrs_tpu_torch``: ``info`` in a subprocess
(it must name the card); then ``run`` in this process, behind the refusing
``requests``: the main run again from the JSON its ``Simulator`` wrote
(counts and summary bitwise equal, the potential from the cache), the
reference's three example regions at their published size (Altamont Pass
800x600 and Appalachian 600x700 at 100 m, JEM 1000x1000 at 50 m; wind
270 deg at 10 m/s, 1,000 recorded tracks each: solver record, launches
against chunks and flushes, counts against the ``.pkl`` recount), one
region's presence map again from its ``.pkl`` (one launch of the count
kernel), and the figures: drawn where matplotlib imports, else ``run``
without ``--no-plots`` must raise ``ImportError`` before any output.

Several devices: a mesh of four entries, every visible card cycled
(four times the one card on a machine with one; a line says how many
distinct cards). The main run's 100,000 tracks again, counts only, through
``Simulator(device=mesh, mesh_devices=4)`` on the cached potential: its
counts are the sum of the sharded driver's shards, and each shard is
bit-identical to the single-device driver on its slice, with as many
chunk launches and flushes; one shard's first 512-step chunk, its flush
and two of its steps (from its start and after the chunk) against the
plain versions; ``simulate_presence_sharded`` (the per-step kernel) with
the main run's mass checks; the direction sweep
again from its cache with its cases over two entries (the sweep's counts
bit for bit); the row-sharded orograph (bitwise the single-device one);
the row-sharded refined solve of the main field (rrel, interior residual,
range, boundary, a bitwise re-solve; its seconds and V-cycles beside the
single-device solve's) and of the hard field (within 0.05 of direct), no
field block moving between shards.

Last, the notebooks (``notebooks/*.ipynb``), through the port's public
surface on the card: terrain_demo's cells (the root imports, the terrain
chain to the synthetic DEM, the reprojection; slope and aspect of the
500x600 elevation as card tensors against the cells' CPU values within
rtol 1e-5 + atol 1e-4; the turbines of the notebook's pandas frame equal
to those of its columns as a dict) and wtk_demo's (on a stand-in archive
for 2014: the frame of one timestamp equal to the stand-in's values);
then every configuration that ssrs_tpu_demo, workshop_cases and
ssrs_modes assign, read from their JSON, through ``Simulator(config)``
and ``simulate_tracks()``: demo_wy (300x250, 2,000 recorded tracks) and
demo_wy_big (100,000 tracks) at their own size, the five workshop cases
and the three ssrs_modes runs at 100 m (the snapshot and seasonal cases
on stand-ins for Altamont Pass in 2012 and the README region in 2012 and
2014). Every case's counts hold the mass checks; demo_wy's ``.pkl``
recount and, at 600x600, one chunk launch from the case's starts and its
flush are exact against the plain versions. Each refined solve that ends
with 1e-5 < rrel <= 5e-3 (inside the Simulator's residual net) is held
against the host direct solve.

Every phase prints one line; any failure exits non-zero. The last three
lines are a JSON object with the solver's, the track engine's, the
count's and the multi-case paths' numbers, one with the kernels' numbers
and the JSON status line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result. It imports nothing of JAX, the port takes
in no requests, and no pandas before the notebooks' cells import it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import datetime

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the main path's shapes: the README run (README.md, "Usage")
NROW, NCOL = 500, 600
N_AGENTS = 100_000
MAIN_CONFIG = dict(
    run_name='wy', southwest_lonlat=(-106.21, 42.78),
    region_width_km=(60., 50.), resolution=100., sim_mode='uniform',
    uniform_winddirn=270., uniform_windspeed=10., track_count=100_000,
    potential_solver='auto', track_max_steps=10_000, sim_seed=7)
# the recorded-track run: the largest run that records with the default
# track_pkl_budget, in the main run's out_dir (its cached potential)
RECORDED_TRACKS = 10_000
# the flush and kernel B at the main path's first compaction (100k
# agents); kernel C at the recorded run's mass (10,000 tracks of ~630
# moves)
HIST_B_POINTS = 100_000
HIST_C_POINTS = 6_400_000
# kernel C's exactness cases: one hot cell, and a grid of twenty bands
HOT_CELL = (321, 77)
HOT_CELL_POINTS = 1_000_000
BANDS_GRID = (1000, 1000)
BANDS_POINTS = 3_000_000
# kernel C's two kernels on 500x600 at these numbers of uniform points,
# and on larger grids (bands) at the recorded run's mass: where the plan
# switches
SWEEP_POINTS = (300_000, 1_200_000, 3_000_000, 4_500_000, 7_500_000)
SWEEP_GRIDS = ((600, 600), (640, 640), (700, 700), (1000, 1000))
SWEEP_GRID_POINTS = 7_500_000
# the new kernels of presence_hist.cu, as ptxas names them
HIST_KERNELS = ('flush_kernel', 'band_count_kernel', 'sum_copies_kernel')
# a small run (the tests' WY config) compared between card and CPU
SMALL_CONFIG = dict(
    run_name='wy_small', sim_mode='uniform', sim_seed=11,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(12., 10.),
    resolution=200., uniform_winddirn=270., uniform_windspeed=10.,
    track_direction=0., track_count=4096, track_start_region=(1., 11., 1., 2.),
    track_start_type='random', track_max_steps=400,
    potential_solver='direct', track_pkl_budget=0, mesh_devices=1)
# the refined solve's gates: scaled relative residual (the JAX package
# reads 1.12e-7 on the main field), the float64 interior residual
# max |x - P x| of the saved potential (the float32-rounded direct answer
# reads ~6.0e-5), the potential's range, and the hard field's max error
# against the direct solve: tests/test_potential.py:205-215 bound it by
# 1.0; the card reads 0.0108, so 0.05 lets a real loss of accuracy fail.
# Neither residual gate sees the main field's near-null mode, along which
# the refined answer sits up to ~100 from the direct one (ROADMAP.md
# section 3): the hard field is the only accuracy gate of the solve.
RREL_MAX = 1e-5
INTERIOR_RESID_MAX = 2e-4
RANGE_SLACK = 1e-3
HARD_SHAPE = (460, 460)
HARD_ERR_MAX = 0.05
# L1 bound between two statistically equivalent presence maps (the bound
# of tests/test_compaction.py)
L1_BOUND = 0.08
# at nu != 1 kernel (expf/logf) and plain (torch exp/log) may round apart
NU2_MIN_EQUAL = 0.999
# the chunk kernel's checks: windows of CHUNK_T steps from step CHUNK_S0,
# before the main run's burn-in (50 steps) ends; the k = 3 windows reach
# the cap CHUNK_CAP
CHUNK_T = 512
CHUNK_S0 = 20
CHUNK_CAP = CHUNK_S0 + 400
# the main-field chunk is also timed in launches of CHUNK_SEG steps: the
# first covers the burn-in, where the starts crowd ~5,000 cells
CHUNK_SEG = 64
# the drivers' chunk length (agents/simulate.py)
DRIVER_CHUNK = 512
# the direction sweep: BASELINE.json's config 2, eight wind directions
SWEEP_DIRNS = (0., 45., 90., 135., 180., 225., 270., 315.)
# the Gaussian filter, card against CPU, as a share of the field's maximum
# (float32 sums of 33 taps, twice, in another order)
GAUSS_TOL = 1e-5
# compute_thermals: the mean mass of THERMAL_SEEDS fields against the
# seeds' expected mass (one 500x600 field holds ~100 seeds of lognormal
# size, so its sum scatters by ~12% and the mean of 8 by ~4%)
THERMAL_SEEDS = 8
THERMAL_MASS_TOL = 0.2
# the WTK stand-in of the snapshot and the seasonal run: an hourly 2-km grid
# over the README region for 2012 (a leap year), the six layers of the
# Simulator's ``wtk_layers`` with ``scale_factor`` attributes
WTK_YEAR = 2012
WTK_HOURS = 24 * 366
WTK_SPACING_KM = 2.
WTK_MARGIN_DEG = 0.06
WTK_SCALE = {'windspeed_100m': 100., 'winddirection_100m': 100.,
             'pressure_100m': 0.1, 'temperature_100m': 100.,
             'boundary_layer_height': 1., 'surface_heat_flux': 1.}
WTK_LAYERS = list(WTK_SCALE)
# the seasonal run: the default seasonal_count, 100,000 tracks a case
SEASONAL_COUNT = 8
# the snapshot run: recorded tracks (RECORDED_TRACKS), one thermal
# realization, and a fixture of this many turbines
SNAPSHOT_DATETIME = (2012, 6, 17, 13)
SNAPSHOT_TURBINES = 48
# the reference's example regions (examples/*.py; copied, since those
# modules import ssrs_tpu), each in the uniform variant of
# examples/_demo.py:35-37, at its published size: (rows, cols) of the grid,
# the config, the source. The seed is the main run's, so that every call
# runs the same tracks (the examples leave it at -1, a fresh seed a run).
CLI_COMMON = dict(sim_mode='uniform', uniform_winddirn=270.,
                  uniform_windspeed=10., track_direction=0.,
                  track_count=1000, sim_seed=7)
CLI_REGIONS = {
    'altamont_pass': ((800, 600), dict(
        southwest_lonlat=(-121.98, 37.56), region_width_km=(60., 80.),
        resolution=100., track_start_region=(2., 58., 0., 1.)),
        'examples/example_altamontpass.py:17-26'),
    'appalachian': ((600, 700), dict(
        southwest_lonlat=(-79.7, 39.), region_width_km=(70., 60.),
        resolution=100., track_start_region=(2., 68., 0., 1.)),
        'examples/example_appalachian.py:15-24'),
    'jem_wy': ((1000, 1000), dict(
        southwest_lonlat=(-106.21, 42.78), region_width_km=(50., 50.),
        resolution=50., track_start_region=(2., 48., 0., 1.)),
        'examples/example_jem.py:16-25'),
}
# the region whose presence map is computed again from its .pkl
CLI_RECOUNT_REGION = 'appalachian'
# an orograph on the card against the CPU's on the same winds: float32
# sines and cosines that differ by ulps (the tolerance of the tests'
# fields against the JAX package's)
ORO_RTOL, ORO_ATOL = 1e-5, 1e-4
# the sharded phase: a mesh of SHARDS entries, every visible card cycled
# (four times cuda:0 on one card); the direction sweep's rerun spreads its
# cases over the first SWEEP_MESH of them
SHARDS = 4
SWEEP_MESH = 2
# the solver options: the direction sweep in one batch of its eight cases;
# the hard field beside three others of its shape (seeds 2-4); the legacy
# multigrid's residual norm on the hard field after 300 V-cycles, which
# both packages read at 7.832 on the CPU (the bound of
# tests/test_potential.py:119-130, 0.012 on its 24x30 field, holds there
# and is checked there)
BATCH_SWEEP = 8
HARD_BATCH_SEEDS = (1, 2, 3, 4)
MG_SHAPE = (24, 30)
MG_HARD_RESID = 7.832
MG_RESID_SLACK = 1.05
# the compacting drivers' default min_bucket (agents/simulate.py)
AUTO_MIN_BUCKET = 1024
# the notebooks (notebooks/*.ipynb): the configurations each assigns, read
# from its JSON, at the workshop's 100 m (workshop_cases.ipynb: "RES =
# 200. # demo resolution (workshop: 100.)"; ssrs_modes.ipynb: "demo
# resolution; production runs use 100 m"); ssrs_tpu_demo's at its own
NOTEBOOK_RES = 100.
NOTEBOOK_RUNS = (
    ('ssrs_tpu_demo', ('config', 'big')),
    ('workshop_cases', ('wy_test1', 'wy_test2', 'alt_test1', 'apl_test1',
                        'apl_test2')),
    ('ssrs_modes', ('config_uniform', 'config_snapshot', 'config_seasonal')))
# the run whose .pkl kernel C recounts, and the run at the largest grid,
# where one chunk launch and its flush are held against the plain versions
NOTEBOOK_RECOUNT = 'config'
NOTEBOOK_CHUNK = 'apl_test1'
# the refined solves that end between these residuals pass the 5e-3 net
# unconverged (ROADMAP.md section 3, fault 3); each is held against the
# host direct solve up to this many cells
STALL_RREL = (RREL_MAX, 5e-3)
STALL_DIRECT_MAX_CELLS = 600 * 600
# BASELINE.json's config 5 ("Large-scale ensemble: 200x200 km @30 m DEM,
# 100k tracks, presence map + turbine-conflict scoring") as a Config of the
# port: the README region's corner, 200x200 km at 30 m (6667x6667 cells),
# the README's wind, its south start band widened to the region, the step
# cap of the other runs. 'auto' picks the refined solver and the bfloat16
# table, and 100,000 tracks, above track_pkl_budget, the counts-only driver
LARGE_CONFIG = dict(
    run_name='large', sim_mode='uniform', southwest_lonlat=(-106.21, 42.78),
    region_width_km=(200., 200.), resolution=30., uniform_winddirn=270.,
    uniform_windspeed=10., track_direction=0., track_count=100_000,
    track_start_region=(5., 195., 1., 2.), track_start_type='random',
    track_max_steps=10_000, potential_solver='auto', sim_seed=7)
LARGE_GRID = (6667, 6667)
# the Simulator's residual net: a refined solve above it falls back, and at
# this size, past potential_fallback_max_unknowns, raises
LARGE_RREL_MAX = 5e-3
# slope, aspect and updraft of the large grid, card against CPU, in row
# bands of this many rows (one halo row each side on the CPU)
LARGE_BAND_ROWS = 1024
# a crop of the large run's field that the host's direct solve can take,
# from the grid's centre, held refined on the card against direct
LARGE_CROP = 600
# the chunk kernel on the large table is timed at the first chunk, where
# the starts crowd a band of the south edge, and from this step, where the
# agents have spread north
LARGE_LATE_STEP = 4096
# the card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# device-memory bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f'nvidia-smi failed: {smi.stderr}')
    say(f'device: {name}, count {torch.cuda.device_count()}')
    say(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    """Build the CUDA kernels (nvcc) and the host track builder (g++), so
    that the runs below time no build. The ptxas report: no stack frame
    or spills in the chunk kernel, no spills in the flush and count
    kernels, whose registers and shared memory it prints."""
    from ssrs_tpu_torch import _build, native
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    log = _build.build_info['log']
    regs = [ln.strip() for ln in log.splitlines() if 'registers' in ln]
    say(f'build: {secs:.2f} s (nvcc {_build.build_info["seconds"]:.2f} s) '
        f'{_build.build_info["path"]}; ptxas: {" | ".join(regs)}')
    report = _ptxas_report(log)
    frames = {k: v['frame'] for k, v in report.items()
              if 'fused_chunk_kernel' in k}
    if len(frames) != 2 or any(v != (0, 0, 0) for v in frames.values()):
        fail(f'chunk kernel: ptxas reports stack frame / spills {frames}')
    say('build: chunk kernel (f32, bf16): 0 bytes stack frame, 0 bytes '
        'spill stores, 0 bytes spill loads')
    hist = {k: v for k, v in report.items()
            if any(n in k for n in HIST_KERNELS)}
    if len(hist) != 4 or any(v['frame'][1:] != (0, 0)
                             for v in hist.values()):
        fail(f'flush and count kernels: ptxas reports spills {hist}')
    for k, v in sorted(hist.items()):
        say(f'build: {k}: {v["frame"][0]} bytes stack frame, 0 bytes '
            f'spill stores, 0 bytes spill loads; {v["used"]}')
    t0 = time.perf_counter()
    if not native.native_available():
        fail('the C++ track builder does not build (g++)')
    say(f'build: C++ track builder {time.perf_counter() - t0:.2f} s')


def _ptxas_report(log):
    """{mangled kernel name: {'frame': (stack frame, spill store, spill
    load bytes), 'used': ptxas's registers and shared-memory line}} from
    nvcc's ``-Xptxas -v`` report."""
    out, current = {}, None
    for line in log.splitlines():
        if 'Function properties for' in line:
            current = line.split('Function properties for')[1].strip()
            out[current] = {'frame': None, 'used': ''}
        elif current and 'bytes stack frame' in line:
            nums = [int(w) for w in line.replace(',', ' ').split()
                    if w.isdigit()]
            out[current]['frame'] = tuple(nums[:3])
        elif current and 'Used' in line and 'registers' in line:
            out[current]['used'] = line.split(':', 1)[1].strip()
    return out


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` through device memory and to do ``flops`` float32
    operations, at the published peaks."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _move_flops(k):
    """Float multiplies and adds of one live agent-step at nu = 1: the
    memory mask and its product with the weights (9 (k + 1) when k > 0),
    the total and the running sum (18) and the threshold (1)."""
    return 19 + (9 * (k + 1) if k > 0 else 0)


def _step_bound(torch, table, a, k):
    """Bound of one fused step on these inputs: each agent's operands
    read once (pr, pc, r, c, the flags, the uniform, the memory) and its
    results written once; each distinct table row a live agent gathers
    read once; each distinct cell a pending agent counts read and written
    once."""
    n, k_rows = a['r'].shape[0], max(k, 1)
    live = a['alive']
    rows = torch.unique((a['pr'].long() * NCOL + a['pc'].long())[live])
    sel = a['palive'] & (a['r'] >= 0) & (a['r'] < NROW) & (a['c'] >= 0) \
        & (a['c'] < NCOL)
    cells = torch.unique((a['r'].long() * NCOL + a['c'].long())[sel])
    nbytes = n * (16 + 2 + 4 + 4 * k_rows) + n * (8 + 4 * k_rows) \
        + rows.numel() * 9 * table.element_size() + cells.numel() * 8
    return _bound(nbytes, int(live.sum()) * _move_flops(k))


def _chunk_bound(n, k, row_bytes, live, cells, emitted_rows=0):
    """Bound of one chunk launch: the state (r, c, memory, two flags) read
    and written once; one uniform per live agent-step; each cell the
    chunk counted read and written once, and its table row read once (the
    rows gathered are the cells visited, burn-in pushes aside); the
    emission rows, if any, written once."""
    state = n * (4 + 4 + 4 * max(k, 1) + 1 + 1) * 2
    nbytes = state + live * 4 + cells * (row_bytes + 8) \
        + emitted_rows * n * 5
    return _bound(nbytes, live * _move_flops(k))


def _step_inputs(torch, rng, dtype, dev):
    """A table and a state at the main path's shapes, with all-zero and
    sparse rows, dead agents and random memory, so that every branch of
    the cascade runs."""
    ncell = NROW * NCOL
    table = rng.random((ncell, 9), dtype=np.float32) * 100.
    kind = rng.random(ncell)
    table[kind < 0.15] = 0.                              # all-zero rows
    sparse = (kind >= 0.15) & (kind < 0.45)
    table[sparse] *= rng.random((int(sparse.sum()), 9)) < 0.2
    table[:, 4] = 0.
    n = N_AGENTS
    t = torch.from_numpy(table).to(dev).to(dtype).contiguous()
    ints = dict(
        pr=rng.integers(1, NROW - 1, n), pc=rng.integers(1, NCOL - 1, n),
        r=rng.integers(0, NROW, n), c=rng.integers(0, NCOL, n),
        mem=rng.integers(0, 9, (1, n)))
    args = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
            for k, v in ints.items()}
    args['alive'] = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    args['palive'] = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    args['u'] = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    return t, args


def _device_ms(torch, fn, steps=60):
    """Median device milliseconds of one call to ``fn``: each call is
    enqueued behind a GPU sleep, so the CUDA events around it see the
    device work and not the host's enqueue time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        torch.cuda._sleep(4_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        times.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in times]))


def _host_ms(torch, fn, steps=100):
    """Wall milliseconds per call, host enqueue included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def phase_kernel(torch):
    from ssrs_tpu_torch.agents.fused_step import (fused_step,
                                                  fused_step_plain)
    from ssrs_tpu_torch.agents.moves import (directional_probs,
                                             restriction_table)
    dev = torch.device('cuda')
    restr = torch.from_numpy(restriction_table()).to(dev)
    dirp = torch.from_numpy(directional_probs(0.)).to(dev)
    rng = np.random.default_rng(2026)
    max_err = 0
    timing = {}
    for dname, dtype in (('float32', torch.float32),
                         ('bfloat16', torch.bfloat16)):
        table, a = _step_inputs(torch, rng, dtype, dev)

        def call(fn, pres, nu):
            return fn(table, restr, dirp, a['pr'], a['pc'], a['r'], a['c'],
                      a['alive'], a['palive'], a['mem'], a['u'], pres,
                      nu=nu, memory_k=1)

        for nu in (1.0, 0.0, 2.0):
            pres_k = torch.zeros(NROW, NCOL, dtype=torch.int32, device=dev)
            pres_p = torch.zeros_like(pres_k)
            out_k = call(fused_step, pres_k, nu)
            out_p = call(fused_step_plain, pres_p, nu)
            torch.cuda.synchronize()
            if not torch.equal(pres_k, pres_p):
                fail(f'{dname} nu={nu}: presence differs from plain')
            if nu in (0.0, 1.0):
                for name, x, y in zip(('new_r', 'new_c', 'new_mem'),
                                      out_k, out_p):
                    err = int((x - y).abs().max())
                    max_err = max(max_err, err)
                    if err:
                        fail(f'{dname} nu={nu}: {name} differs from plain '
                             f'(max abs err {err})')
                say(f'kernel {dname} nu={nu}: exact match with plain '
                    f'(N={N_AGENTS}, {NROW}x{NCOL})')
            else:
                same = ((out_k[0] == out_p[0]) & (out_k[1] == out_p[1]))
                frac = float(same.to(torch.float64).mean())
                if frac < NU2_MIN_EQUAL:
                    fail(f'{dname} nu={nu}: only {frac:.6f} of moves equal')
                say(f'kernel {dname} nu={nu}: {frac:.6f} of moves equal '
                    f'(>= {NU2_MIN_EQUAL})')
        pres = torch.zeros(NROW, NCOL, dtype=torch.int32, device=dev)
        timing[dname] = {
            'ms': _device_ms(torch, lambda: call(fused_step, pres, 1.0)),
            'plain_ms': _device_ms(
                torch, lambda: call(fused_step_plain, pres, 1.0)),
            'host_ms': _host_ms(torch, lambda: call(fused_step, pres, 1.0)),
            'plain_host_ms': _host_ms(
                torch, lambda: call(fused_step_plain, pres, 1.0)),
        }
        tm = timing[dname]
        tm['bound_ms'], tm['bound_by'] = _step_bound(torch, table, a, 1)
        say(f'timing {dname} N={N_AGENTS}: kernel {tm["ms"] * 1e3:.1f} us '
            f'device / {tm["host_ms"] * 1e3:.1f} us wall per step; plain '
            f'{tm["plain_ms"] * 1e3:.1f} us device / '
            f'{tm["plain_host_ms"] * 1e3:.1f} us wall per step; bound '
            f'{tm["bound_ms"] * 1e3:.2f} us ({tm["bound_by"]})')
    return max_err, timing


def _chunk_state(torch, rng, k, dev):
    """A population over the whole grid (border cells included), 10% dead
    and 10% with nothing pending, with random memory."""
    n = N_AGENTS
    ints = dict(r=rng.integers(0, NROW, n), c=rng.integers(0, NCOL, n),
                mem=rng.integers(0, 9, (max(k, 1), n)))
    st = {name: torch.from_numpy(v.astype(np.int32)).to(dev)
          for name, v in ints.items()}
    st['alive'] = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    st['palive'] = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    return st


def _emission(torch, t_len, fill, dev):
    """Emission rows filled with ``fill``, so that an unwritten row shows."""
    return (torch.full((t_len, N_AGENTS, 2), fill, dtype=torch.int16,
                       device=dev),
            torch.full((t_len, N_AGENTS), fill > 0, dtype=torch.bool,
                       device=dev))


def phase_chunk(torch):
    """The chunk kernel against its plain version on the card, exactly:
    N=100k on 500x600, both table dtypes, nu in {0, 1}, k in {0, 1, 3},
    CHUNK_T steps from before the burn-in's end (the k = 3 windows past
    the cap, and without emission rows); then nu = 2 at T = 1."""
    from ssrs_tpu_torch.agents.fused_chunk import (fused_chunk,
                                                   fused_chunk_plain)
    from ssrs_tpu_torch.agents.moves import (directional_probs,
                                             restriction_table)
    dev = torch.device('cuda')
    restr = torch.from_numpy(restriction_table()).to(dev)
    dirp = torch.from_numpy(directional_probs(0.)).to(dev)
    rng = np.random.default_rng(2029)
    gen = torch.Generator(device=dev).manual_seed(2029)
    burnin = min(NROW, NCOL) // 10
    max_err = 0

    def run(fn, table, st, u, pres, nu, k, nsteps, emit):
        fn(table, restr, dirp, st['r'], st['c'], st['mem'], st['alive'],
           st['palive'], u, pres, nu=nu, memory_k=k, s0=CHUNK_S0,
           burnin=burnin, nsteps=nsteps, emit=emit)

    for dname, dtype in (('float32', torch.float32),
                         ('bfloat16', torch.bfloat16)):
        table, _ = _step_inputs(torch, rng, dtype, dev)
        for k in (0, 1, 3):
            for nu in (1.0, 0.0):
                st_k = _chunk_state(torch, rng, k, dev)
                st_p = {name: v.clone() for name, v in st_k.items()}
                u = torch.rand((CHUNK_T, N_AGENTS), generator=gen,
                               device=dev)
                nsteps = CHUNK_CAP if k == 3 else 10_000
                emit_k = emit_p = None
                if k != 3:
                    emit_k = _emission(torch, CHUNK_T, -7, dev)
                    emit_p = _emission(torch, CHUNK_T, 11, dev)
                pres_k = torch.zeros(NROW, NCOL, dtype=torch.int32,
                                     device=dev)
                pres_p = torch.zeros_like(pres_k)
                run(fused_chunk, table, st_k, u, pres_k, nu, k, nsteps,
                    emit_k)
                run(fused_chunk_plain, table, st_p, u, pres_p, nu, k,
                    nsteps, emit_p)
                torch.cuda.synchronize()
                pairs = [(name, st_k[name], st_p[name]) for name in st_k]
                pairs.append(('presence', pres_k, pres_p))
                if emit_k is not None:
                    pairs += [('emitted positions', emit_k[0], emit_p[0]),
                              ('emitted flags', emit_k[1], emit_p[1])]
                for name, x, y in pairs:
                    err = int((x.long() - y.long()).abs().max())
                    max_err = max(max_err, err)
                    if err:
                        fail(f'chunk {dname} k={k} nu={nu}: {name} differs '
                             f'from plain (max abs err {err})')
                left = int(st_k['alive'].sum())
                if k == 3 and left:
                    fail(f'chunk {dname} k={k}: {left} agents alive past '
                         'the cap')
                say(f'chunk kernel {dname} k={k} nu={nu}: exact match with '
                    f'plain (N={N_AGENTS}, {NROW}x{NCOL}, T={CHUNK_T} from '
                    f'step {CHUNK_S0}, burn-in {burnin}, cap {nsteps}; '
                    f'{"with" if emit_k else "no"} emission rows; '
                    f'{left} alive after)')
        st_k = _chunk_state(torch, rng, 1, dev)
        st_p = {name: v.clone() for name, v in st_k.items()}
        u = torch.rand((1, N_AGENTS), generator=gen, device=dev)
        pres_k = torch.zeros(NROW, NCOL, dtype=torch.int32, device=dev)
        pres_p = torch.zeros_like(pres_k)
        run(fused_chunk, table, st_k, u, pres_k, 2.0, 1, 10_000, None)
        run(fused_chunk_plain, table, st_p, u, pres_p, 2.0, 1, 10_000, None)
        torch.cuda.synchronize()
        same = (st_k['r'] == st_p['r']) & (st_k['c'] == st_p['c'])
        frac = float(same.to(torch.float64).mean())
        if frac < NU2_MIN_EQUAL or not torch.equal(pres_k, pres_p):
            fail(f'chunk {dname} nu=2: {frac:.6f} of moves equal, or the '
                 'presence differs')
        say(f'chunk kernel {dname} nu=2 T=1: {frac:.6f} of moves equal '
            f'(>= {NU2_MIN_EQUAL}), presence exact')
    return max_err


def _scatter_indices(rng, n):
    """(rows, cols) on the 500x600 grid, about 3% of them out of range:
    row -1, row NROW, col NCOL + 77."""
    r = rng.integers(0, NROW, n)
    c = rng.integers(0, NCOL, n)
    odd = rng.random(n)
    r[odd < 0.01] = -1
    r[(odd >= 0.01) & (odd < 0.02)] = NROW
    c[(odd >= 0.02) & (odd < 0.03)] = NCOL + 77
    return r, c


def phase_hist(torch):
    """The flush kernel, kernel B (the weighted histogram, which no path
    runs since the flush has its own kernel) and kernel C against their
    plain versions on the card at their paths' shapes (exact), and their
    times; C also on one hot cell and on a grid of three bands (each of
    its kernels exact), and its two kernels timed across numbers of
    points and grid sizes, where its plan switches between them."""
    from ssrs_tpu_torch.agents import presence_hist as ph
    dev = torch.device('cuda')
    rng = np.random.default_rng(2027)
    r, c = _scatter_indices(rng, HIST_B_POINTS)
    rb = torch.from_numpy(r.astype(np.int32)).to(dev)
    cb = torch.from_numpy(c.astype(np.int32)).to(dev)
    wb = torch.from_numpy(
        (rng.random(HIST_B_POINTS) < 0.6).astype(np.float32)).to(dev)
    # the library yardstick: one index_put_ with accumulation into a new
    # int32 map, on the in-range points' long indices and int32 values,
    # made here and not timed (the weights are 0/1 integers)
    r_in, c_in, sel = _in_range_long(torch, rb, cb, NROW, NCOL)
    lib_b = (r_in, c_in, wb.to(torch.int32)[sel])
    # the other library call: one bincount of the in-range points' flat
    # cells with the weights, made here and not timed
    bin_b = (r_in * NCOL + c_in, wb[sel])

    def kernel():
        return ph.presence_histogram(rb, cb, wb, NROW, NCOL)

    def plain():
        return ph.presence_histogram_plain(rb, cb, wb, NROW, NCOL)

    def library():
        return _index_put_map(torch, *lib_b, (NROW, NCOL))

    def bincount():
        return _bincount_map(torch, bin_b[0], (NROW, NCOL), bin_b[1])

    got, want, lib = kernel(), plain(), library()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err or int(want.sum()) <= 0 or not torch.equal(lib, want) or \
            not torch.equal(bincount().to(torch.int32), want):
        fail(f'presence_histogram: differs from plain (max abs err {err}), '
             'or a library call does')
    tm = {'max_abs_err': err, 'ms': _device_ms(torch, kernel),
          'plain_ms': _device_ms(torch, plain),
          'library_ms': _device_ms(torch, library),
          'bincount_ms': _device_ms(torch, bincount),
          'host_ms': _host_ms(torch, kernel),
          'plain_host_ms': _host_ms(torch, plain)}
    # rows, cols, weights read once; the map written once
    tm['bound_ms'], tm['bound_by'] = _bound(
        HIST_B_POINTS * 12 + NROW * NCOL * 4, 0)
    out = {'presence_histogram': tm}
    say(f'presence_histogram (N={HIST_B_POINTS} 0/1 weights, {NROW}x{NCOL};'
        f' no path runs it): exact match with plain; kernel '
        f'{tm["ms"] * 1e3:.1f} us device / {tm["host_ms"] * 1e3:.1f} us '
        f'wall; plain {tm["plain_ms"] * 1e3:.1f} us device / '
        f'{tm["plain_host_ms"] * 1e3:.1f} us wall; library index_put_ '
        f'{tm["library_ms"] * 1e3:.1f} us, bincount '
        f'{tm["bincount_ms"] * 1e3:.1f} us device; bound '
        f'{tm["bound_ms"] * 1e3:.2f} us ({tm["bound_by"]})')
    base = torch.from_numpy(
        rng.integers(0, 50, (NROW, NCOL)).astype(np.int32)).to(dev)
    out['presence_flush'] = _flush_case(
        torch, rb, cb, wb > 0, base,
        f'N={HIST_B_POINTS} synthetic, 60% pending')

    r, c = _scatter_indices(rng, HIST_C_POINTS)
    r[rng.random(HIST_C_POINTS) < 0.3] = -1
    rc = torch.from_numpy(r.astype(np.int16)).to(dev)
    cc = torch.from_numpy(c.astype(np.int16)).to(dev)
    out['presence_histogram_batch'] = _count_case(
        torch, rc, cc, (NROW, NCOL), f'M={HIST_C_POINTS} int16, 30% dead')
    hot = np.empty((2, HOT_CELL_POINTS), np.int16)
    hot[0], hot[1] = HOT_CELL
    hot = torch.from_numpy(hot).to(dev)
    out['count_hot_cell'] = _count_case(
        torch, hot[0], hot[1], (NROW, NCOL),
        f'M={HOT_CELL_POINTS} int16 in one cell', steps=10)
    r = rng.integers(-1, BANDS_GRID[0], BANDS_POINTS).astype(np.int16)
    c = rng.integers(0, BANDS_GRID[1], BANDS_POINTS).astype(np.int16)
    out['count_bands'] = _count_case(
        torch, torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev),
        BANDS_GRID, f'M={BANDS_POINTS} int16 on twenty bands', steps=20)
    sweep = []
    for grid, m in [((NROW, NCOL), m) for m in SWEEP_POINTS] + \
            [(g, SWEEP_GRID_POINTS) for g in SWEEP_GRIDS]:
        r = torch.from_numpy(rng.integers(0, grid[0], m).astype(np.int16))
        c = torch.from_numpy(rng.integers(0, grid[1], m).astype(np.int16))
        case = _count_case(torch, r.to(dev), c.to(dev), grid,
                           f'sweep: M={m} int16 uniform', steps=20)
        sweep.append({'grid': list(grid), 'points': m, **case})
    out['count_sweep'] = sweep
    return out


def _flush_case(torch, rows, cols, palive, base, what):
    """The flush kernel on these pending points, into copies of the map
    ``base``: exactly equal to its plain version and to the flush it
    replaced (the weighted kernel with the flags as weights, added into
    the map; its flags cleared into a new tensor); then both timed in
    turns (flush, old, old, flush), beside the old weighted kernel alone,
    the plain version, one index_put_ and the bound. Returns the times."""
    from ssrs_tpu_torch.agents import presence_hist as ph
    nrow, ncol = base.shape
    maps = [base.clone() for _ in range(3)]
    cleared = ph.presence_flush(rows, cols, palive, maps[0])
    plain_flags = ph.presence_flush_plain(rows, cols, palive, maps[1])
    maps[2].add_(ph.presence_histogram(rows, cols, palive.to(torch.float32),
                                       nrow, ncol))
    torch.cuda.synchronize()
    err = int((maps[0].long() - maps[1].long()).abs().max())
    if err or not torch.equal(maps[0], maps[2]) or cleared.any() or \
            plain_flags.any() or torch.equal(maps[0], base):
        fail(f'presence_flush ({what}): differs from plain (max abs err '
             f'{err}) or from the weighted flush')
    sel = _in_range_long(torch, rows, cols, nrow, ncol)[2] & palive
    r_in, c_in = rows[sel].long(), cols[sel].long()
    ones = torch.ones_like(r_in, dtype=torch.int32)
    flat = r_in * ncol + c_in
    weights = palive.to(torch.float32)
    work = base.clone()
    if not torch.equal(base + _bincount_map(torch, flat, (nrow, ncol)),
                       maps[0]):
        fail(f'presence_flush ({what}): the bincount of the pending points '
             'differs from the flush')

    def flush():
        return ph.presence_flush(rows, cols, palive, work)

    def old_flush():
        work.add_(ph.presence_histogram(rows, cols, palive.to(torch.float32),
                                        nrow, ncol))
        return torch.zeros_like(palive)

    turns = {'ms': [], 'old_ms': []}
    for name, fn in (('ms', flush), ('old_ms', old_flush),
                     ('old_ms', old_flush), ('ms', flush)):
        turns[name].append(_device_ms(torch, fn))
    tm = {'max_abs_err': err, 'ms': float(np.mean(turns['ms'])),
          'ms_turns': turns['ms'], 'old_flush_ms': turns['old_ms'],
          'old_kernel_ms': _device_ms(torch, lambda: ph.presence_histogram(
              rows, cols, weights, nrow, ncol)),
          'plain_ms': _device_ms(torch, lambda: ph.presence_flush_plain(
              rows, cols, palive, work)),
          'library_ms': _device_ms(torch, lambda: work.index_put_(
              (r_in, c_in), ones, accumulate=True)),
          'bincount_ms': _device_ms(torch, lambda: _bincount_map(
              torch, flat, (nrow, ncol))),
          'host_ms': _host_ms(torch, flush),
          'old_flush_host_ms': _host_ms(torch, old_flush),
          'points': rows.shape[0], 'pending': int(sel.sum())}
    # rows, cols and flags read once, the cleared flags written once; each
    # cell the flush counts read and written once
    cells = int(torch.unique(r_in * ncol + c_in).numel())
    tm['bound_ms'], tm['bound_by'] = _bound(rows.shape[0] * 10 + cells * 8,
                                            0)
    say(f'presence_flush ({what}, {nrow}x{ncol}, {tm["pending"]} pending '
        f'in {cells} cells): exact match with plain and with the weighted '
        f'flush; in turns flush {turns["ms"][0] * 1e3:.2f} us, old flush '
        f'{turns["old_ms"][0] * 1e3:.2f} us, old flush '
        f'{turns["old_ms"][1] * 1e3:.2f} us, flush '
        f'{turns["ms"][1] * 1e3:.2f} us device (old weighted kernel alone '
        f'{tm["old_kernel_ms"] * 1e3:.2f} us); wall: flush '
        f'{tm["host_ms"] * 1e3:.1f} us, old flush '
        f'{tm["old_flush_host_ms"] * 1e3:.1f} us; plain '
        f'{tm["plain_ms"] * 1e3:.1f} us; library index_put_ '
        f'{tm["library_ms"] * 1e3:.1f} us, bincount '
        f'{tm["bincount_ms"] * 1e3:.1f} us device; bound '
        f'{tm["bound_ms"] * 1e3:.3f} us ({tm["bound_by"]})')
    return tm


def _count_case(torch, rows, cols, grid, what, steps=60):
    """Kernel C on these points: the plan's kernel, and each kernel
    forced (direct, privatized), exactly equal to the plain version and
    to one index_put_; then both kernels timed in turns (direct,
    privatized, privatized, direct), beside the plain version, the
    library call and the bound. Returns the plan and the times; ``ms`` is
    the plan's kernel's."""
    from ssrs_tpu_torch.agents import presence_hist as ph
    nrow, ncol = grid
    m = rows.shape[0]
    plan = ph._count_plan(nrow, ncol, m, ph._sms(rows.device.index))
    plans = {'direct': plan._replace(kernel='direct'),
             'privatized': plan._replace(kernel='privatized')}
    want = ph.presence_histogram_batch_plain(rows, cols, nrow, ncol)
    r_in, c_in, _ = _in_range_long(torch, rows, cols, nrow, ncol)
    ones = torch.ones_like(r_in, dtype=torch.int32)
    flat = r_in * ncol + c_in
    lib = _index_put_map(torch, r_in, c_in, ones, grid)
    got = {name: ph.presence_histogram_batch(rows, cols, nrow, ncol, plan=p)
           for name, p in [('plan', plan), *plans.items()]}
    torch.cuda.synchronize()
    err = max(int((g.long() - want.long()).abs().max()) for g in got.values())
    if err or not torch.equal(lib, want) or int(want.sum()) <= 0 or \
            not torch.equal(_bincount_map(torch, flat, grid).to(torch.int32),
                            want):
        fail(f'presence_histogram_batch ({what}): differs from plain (max '
             f'abs err {err}), or a library call does')
    turns = {name: [] for name in plans}
    for name in ('direct', 'privatized', 'privatized', 'direct'):
        turns[name].append(_device_ms(
            torch, lambda: ph.presence_histogram_batch(
                rows, cols, nrow, ncol, plan=plans[name]), steps=steps))
    ms = {name: float(np.mean(t)) for name, t in turns.items()}
    tm = {'max_abs_err': err, 'plan': plan._asdict(),
          'ms': ms[plan.kernel], 'kernels_ms': turns,
          'plain_ms': _device_ms(
              torch, lambda: ph.presence_histogram_batch_plain(
                  rows, cols, nrow, ncol), steps=steps),
          'library_ms': _device_ms(torch, lambda: _index_put_map(
              torch, r_in, c_in, ones, grid), steps=steps),
          'bincount_ms': _device_ms(torch, lambda: _bincount_map(
              torch, flat, grid), steps=steps),
          'host_ms': _host_ms(torch, lambda: ph.presence_histogram_batch(
              rows, cols, nrow, ncol), steps=20),
          'points': m, 'in_grid': int(r_in.numel()),
          'cells_hit': int((want > 0).sum())}
    # the points read once, the map written once
    tm['bound_ms'], tm['bound_by'] = _bound(
        m * 2 * rows.element_size() + nrow * ncol * 4, 0)
    say(f'presence_histogram_batch ({what}, {nrow}x{ncol}, {tm["in_grid"]} '
        f'in the grid, {tm["cells_hit"]} cells hit; plan {plan.kernel}, '
        f'{plan.bands} bands x {plan.shares} shares): both kernels exact; in '
        f'turns (us device) direct {turns["direct"][0] * 1e3:.1f} / '
        f'{turns["direct"][1] * 1e3:.1f}, privatized '
        f'{turns["privatized"][0] * 1e3:.1f} / '
        f'{turns["privatized"][1] * 1e3:.1f}; plan\'s kernel '
        f'{tm["host_ms"] * 1e3:.1f} us wall; plain '
        f'{tm["plain_ms"] * 1e3:.1f} us; library index_put_ '
        f'{tm["library_ms"] * 1e3:.1f} us, bincount '
        f'{tm["bincount_ms"] * 1e3:.1f} us; bound {tm["bound_ms"] * 1e3:.2f} '
        f'us ({tm["bound_by"]})')
    return tm


def _in_range_long(torch, rows, cols, nrow, ncol):
    """(rows, cols) of the in-grid points as int64, and the in-grid mask."""
    r, c = rows.long(), cols.long()
    sel = (r >= 0) & (r < nrow) & (c >= 0) & (c < ncol)
    return r[sel], c[sel], sel


def _index_put_map(torch, r, c, values, grid):
    """The library yardstick of a presence histogram: one accumulating
    index_put_ into a new int32 map."""
    out = torch.zeros(grid, dtype=torch.int32, device=r.device)
    return out.index_put_((r, c), values, accumulate=True)


def _bincount_map(torch, flat, grid, weights=None):
    """The other library call that computes a presence histogram: one
    bincount of the in-grid points' flat cells (with ``weights``, their
    weighted sums), as a map of ``grid``."""
    return torch.bincount(flat, weights=weights,
                          minlength=grid[0] * grid[1]).view(grid)


def _reset_counts():
    from ssrs_tpu_torch.agents import (fused_chunk, fused_step,
                                       presence_hist, simulate)
    fused_step.reset_launch_count()
    fused_chunk.reset_launch_count()
    presence_hist.reset_launch_count()
    simulate.reset_flush_count()


def _read_counts():
    from ssrs_tpu_torch.agents import (fused_chunk, fused_step,
                                       presence_hist, simulate)
    return {'fused_step': fused_step.launch_count(),
            'fused_chunk': fused_chunk.launch_count(),
            'fused_chunk_steps': fused_chunk.steps_count(),
            'presence_flush': presence_hist.launch_count('presence_flush'),
            'presence_histogram':
                presence_hist.launch_count('presence_histogram'),
            'presence_histogram_batch':
                presence_hist.launch_count('presence_histogram_batch'),
            'flushes': simulate.flush_count()}


def _run_starts(cfg):
    """The ``(N, 2)`` int32 start cells that a fresh ``Simulator`` of
    ``cfg`` (a ``Config`` or a ``Simulator``) draws first."""
    from ssrs_tpu_torch.agents import get_starting_indices
    rows, cols = get_starting_indices(
        cfg.track_count, list(cfg.track_start_region), cfg.track_start_type,
        tuple(cfg.region_width_km), float(cfg.resolution),
        rng=np.random.default_rng(cfg.sim_seed))
    return np.stack([rows, cols], axis=1).astype(np.int32)


def phase_main(torch, device_name, out):
    """The uniform-mode run of 100,000 tracks, in ``out``."""
    from ssrs_tpu_torch import Config, Simulator
    cfg = Config(out_dir=out, **MAIN_CONFIG)
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    ctor = time.perf_counter() - t0
    _reset_counts()
    sim.simulate_tracks()
    launched = _read_counts()
    sim.compute_presence_map()
    records = {r['phase']: r for r in sim.timer.records}
    steps = records['tracks']['steps']
    _check_chunk_launches('main path', launched, steps)
    _check_flush_launches('main path', launched)
    counts = sim.get_presence_counts(sim.case_ids[0], 0)
    if counts.shape != (NROW, NCOL) or not np.isfinite(counts).all() \
            or counts.min() < 0:
        fail('main path: counts are not a finite non-negative '
             f'{NROW}x{NCOL} map')
    floor = cfg.track_count * (sim.grid.burnin_length() + 1)
    total = int(counts.sum(dtype=np.int64))
    if total < floor:
        fail(f'main path: presence mass {total} < {floor}')
    summary = np.load(os.path.join(sim.mode_data_dir,
                                   'summary_presence.npy'))
    if summary.shape != (NROW, NCOL) or summary.max() != 1.0:
        fail('main path: summary_presence.npy is not max-normalized')
    useful = records['tracks']['useful_steps']
    tracks_s = records['tracks']['seconds']
    say('main path phases (s): ' + ', '.join(
        f'{k} {records[k]["seconds"]:.3f}' for k in
        ('terrain', 'updrafts', 'potential', 'tracks',
         'simulate_tracks', 'presence_map')) + f'; ctor {ctor:.3f}')
    say(f'main path: {steps} steps, {launched["fused_chunk"]} chunk kernel '
        f'launches covering {launched["fused_chunk_steps"]} steps, '
        f'{launched["fused_step"]} per-step launches, '
        f'{launched["flushes"]} flushes through '
        f'{launched["presence_flush"]} flush kernel launches, {useful} '
        f'agent-steps in {tracks_s:.3f} s = {useful / tracks_s:.4g} '
        f'agent-steps/s on {device_name}')
    return launched, sim


def _check_chunk_launches(label, launched, steps):
    """The drivers' launches: one chunk kernel launch a chunk (each of the
    runs' chunks, at most 100,000 agents x DRIVER_CHUNK steps, is one
    uniform block), covering every step, and no per-step launch. ``steps``
    is one run's steps, or those of several runs counted together."""
    steps = [steps] if isinstance(steps, int) else list(steps)
    chunks = sum(math.ceil(s / DRIVER_CHUNK) for s in steps)
    if min(steps) <= 0 or launched['fused_chunk'] != chunks or \
            launched['fused_chunk_steps'] != sum(steps) or \
            launched['fused_step']:
        fail(f'{label}: {launched["fused_chunk"]} chunk launches covering '
             f'{launched["fused_chunk_steps"]} steps and '
             f'{launched["fused_step"]} per-step launches, for {steps} '
             f'steps in {chunks} chunks')


def _check_flush_launches(label, launched, flushes=None):
    """Every flush is one launch of the flush kernel, and the weighted
    histogram runs on no path."""
    if launched['presence_flush'] != launched['flushes'] or \
            launched['flushes'] < 1 or launched['presence_histogram'] or \
            flushes not in (None, launched['flushes']):
        fail(f'{label}: {launched["presence_flush"]} flush kernel launches '
             f'and {launched["presence_histogram"]} weighted histogram '
             f'launches for {launched["flushes"]} flushes')


def _check_tracks(tracks, starts, nrow, ncol, burnin, cap):
    """The recorded tracks' invariants, exact: int16 C-contiguous
    ``(len, 2)`` arrays that start at their start cells and stay in the
    grid, ``burnin + 1 <= len <= cap + 1``, a track shorter than the cap
    ends on the boundary, and after the burn-in consecutive cells are
    neighbours. Returns the lengths."""
    if len(tracks) != len(starts):
        fail(f'recorded run: {len(tracks)} tracks for {len(starts)} starts')
    for t in tracks:
        if t.dtype != np.int16 or t.ndim != 2 or t.shape[1] != 2 \
                or not t.flags.c_contiguous:
            fail(f'recorded run: a track is {t.dtype} {t.shape}, not a '
                 'C-contiguous int16 (len, 2) array')
    lengths = np.array([len(t) for t in tracks])
    if lengths.min() < burnin + 1 or lengths.max() > cap + 1:
        fail(f'recorded run: lengths {lengths.min()}..{lengths.max()} '
             f'outside [{burnin + 1}, {cap + 1}]')
    flat = np.concatenate(tracks).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    if not np.array_equal(flat[first], starts):
        fail('recorded run: a track does not start at its start cell')
    if flat[:, 0].min() < 0 or flat[:, 0].max() >= nrow or \
            flat[:, 1].min() < 0 or flat[:, 1].max() >= ncol:
        fail('recorded run: a track leaves the grid')
    last = flat[first + lengths - 1]
    on_edge = (last[:, 0] == 0) | (last[:, 0] == nrow - 1) | \
        (last[:, 1] == 0) | (last[:, 1] == ncol - 1)
    if not on_edge[lengths < cap + 1].all():
        fail('recorded run: a track ended before the cap off the boundary')
    # index of each point within its track; the move into point k comes
    # after the burn-in when k >= burnin + 2
    k = np.arange(len(flat)) - np.repeat(first, lengths)
    moves = np.abs(np.diff(flat, axis=0)).max(axis=1)
    if moves[k[1:] >= burnin + 2].max(initial=0) > 1:
        fail('recorded run: a move after the burn-in is not to a neighbour')
    return lengths


def phase_recorded(torch, device_name, out):
    """The recorded-track run: the README region with 10,000 tracks (the
    default track_pkl_budget), in the main run's ``out`` so that its
    potential comes from the cache."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents.presence import track_points
    from ssrs_tpu_torch.agents.presence_hist import presence_histogram_batch
    cfg = Config(out_dir=out, **{**MAIN_CONFIG,
                                 'track_count': RECORDED_TRACKS})
    if cfg.track_count > cfg.track_pkl_budget:
        fail('recorded run: the config does not record')
    sim = Simulator(cfg)
    _reset_counts()
    sim.simulate_tracks()
    launched = _read_counts()
    records = {r['phase']: r for r in sim.timer.records}
    rec = records['tracks']
    steps = rec['steps']
    _check_chunk_launches('recorded run', launched, steps)
    _check_flush_launches('recorded run', launched)
    if 'potential' not in records or records['potential']['seconds'] > 1. \
            or records['potential']['solver'] != 'cache':
        fail('recorded run: the potential was not read from the cache')
    if not rec.get('recorded'):
        fail('recorded run: the tracks phase did not record')
    if rec['builder'] != 'native':
        fail(f'recorded run: the {rec["builder"]} track builder ran, not '
             'the C++ one')
    data = sim.mode_data_dir
    ident = sim._get_id_string(sim.case_ids[0], 0)
    with open(os.path.join(data, f'{ident}_tracks.pkl'), 'rb') as fobj:
        tracks = pickle.load(fobj)
    lengths = _check_tracks(tracks, _run_starts(cfg), NROW, NCOL,
                            sim.grid.burnin_length(), cfg.track_max_steps)
    counts_path = os.path.join(data, f'{ident}_counts.npy')
    counts = np.load(counts_path)
    if int(counts.sum(dtype=np.int64)) != int(lengths.sum()):
        fail(f'recorded run: counts mass {counts.sum()} != sum of lengths '
             f'{lengths.sum()}')
    # the pkl fallback of get_presence_counts: one recount through
    # kernel C, returned as int16, as the JAX package's
    os.replace(counts_path, counts_path + '.moved')
    _reset_counts()
    fallback = sim.get_presence_counts(sim.case_ids[0], 0)
    recounted = _read_counts()
    if recounted['presence_histogram_batch'] != 1 or \
            recounted['fused_step'] or recounted['fused_chunk'] or \
            recounted['presence_histogram'] or recounted['presence_flush']:
        fail(f'recorded run: the pkl fallback launched {recounted}, not '
             'the count kernel once')
    launched['presence_histogram_batch'] = \
        recounted['presence_histogram_batch']
    # the int32 recount of the .pkl through kernel C, cell for cell (after
    # the counts are read: these launches are the smoke's, not the path's),
    # on the planes the path lays out; each kernel timed on them
    rows_pkl, cols_pkl = track_points(tracks, sim.device)
    recount = presence_histogram_batch(rows_pkl, cols_pkl, NROW, NCOL)
    if not np.array_equal(recount.cpu().numpy(), counts):
        fail('recorded run: _counts.npy differs from the recount of the pkl')
    count_real = _count_case(
        torch, rows_pkl, cols_pkl, (NROW, NCOL),
        f'the recorded run\'s .pkl, {len(tracks)} tracks')
    if fallback.dtype != np.int16 or \
            not np.array_equal(fallback, counts.astype(np.int16)):
        fail('recorded run: get_presence_counts without _counts.npy is not '
             'the int16 recount')
    useful = rec['useful_steps']
    say(f'recorded run: {cfg.track_count} tracks, {steps} steps, '
        f'{launched["fused_chunk"]} chunk kernel launches, '
        f'{launched["flushes"]} flushes, {useful} agent-steps in '
        f'{rec["seconds"]:.3f} s = {useful / rec["seconds"]:.4g} '
        f'agent-steps/s on {device_name}; track rebuild '
        f'{rec["build_seconds"]:.3f} s (C++), .pkl write '
        f'{records["write_tracks"]["seconds"]:.3f} s; exact: tracks, '
        'counts = recount, int16 fallback')
    return launched, count_real


def _timed_solve(torch, cond, dirn, tol=1e-7):
    """(potential on the host, rrel, stats, wall seconds) of one refined
    solve of the card tensor ``cond``."""
    from ssrs_tpu_torch.potential import (boundary_masks,
                                          solve_potential_refined)
    bmask, bvals = boundary_masks(dirn, tuple(cond.shape))
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pot, rrel = solve_potential_refined(cond, bmask, bvals, tol=tol,
                                        stats=stats)
    torch.cuda.synchronize()
    return pot.cpu().numpy(), rrel, stats, time.perf_counter() - t0


def _profile_launches(torch, fn):
    """(kernel launches, device milliseconds, wall seconds) of ``fn()``
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = device_us = 0
    for ev in prof.key_averages():
        if ev.key in ('cudaLaunchKernel', 'cuLaunchKernel',
                      'cudaLaunchKernelExC', 'cuLaunchKernelEx'):
            launches += ev.count
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us += getattr(ev, 'self_device_time_total',
                                 getattr(ev, 'self_cuda_time_total', 0))
    return launches, device_us / 1e3, wall


def phase_solver(torch, sim, device_name):
    """The main run's refined potential: its record, the invariants of
    the reference's system, two more solves on the card (bitwise equal to
    the run's; the second profiled), the host direct solve beside it;
    then the 460x460 hard field against the direct solve."""
    from ssrs_tpu_torch.potential import solve_potential_direct
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    from ssrs_tpu_torch.potential.direct import interior_residual
    from ssrs_tpu_torch.potential.fields import conductivity_hard
    rec = {r['phase']: r for r in sim.timer.records}['potential']
    if rec['solver'] != 'refined' or rec['fallback'] is not False or \
            not rec['rrel'] < RREL_MAX:
        fail(f'main path: potential record {rec}')
    dirn = float(sim.track_direction)
    cond = sim.load_updrafts(sim.case_ids[0])[0]
    cond_np = cond.cpu().numpy()
    ident = sim._get_id_string(sim.case_ids[0], 0)
    pot = np.load(os.path.join(sim.mode_data_dir, f'{ident}_potential.npy'))
    bmask, bvals = boundary_masks(dirn, pot.shape)
    resid = interior_residual(pot, cond_np, dirn)
    if not resid <= INTERIOR_RESID_MAX:
        fail(f'main path: interior residual {resid:.3e} > '
             f'{INTERIOR_RESID_MAX}')
    if pot.min() < -RANGE_SLACK or pot.max() > 1000. + RANGE_SLACK or \
            not np.array_equal(pot[bmask], bvals[bmask]):
        fail(f'main path: potential range {pot.min()}..{pot.max()} or '
             'its boundary is off')
    warm = []
    for _ in range(2):
        got, rrel, stats, secs = _timed_solve(torch, cond, dirn,
                                              sim.potential_tol)
        warm.append(secs)
        if not np.array_equal(got, pot) or rrel != rec['rrel']:
            fail('main path: a second solve on the card is not bitwise '
                 'equal to the run\'s')
    launches, device_ms, prof_s = _profile_launches(
        torch, lambda: _timed_solve(torch, cond, dirn, sim.potential_tol))
    t0 = time.perf_counter()
    direct = solve_potential_direct(cond_np, dirn).astype(np.float64)
    direct_s = time.perf_counter() - t0
    diff = np.abs(pot.astype(np.float64) - direct)
    say(f'solver, main field {pot.shape[0]}x{pot.shape[1]}: rrel '
        f'{rec["rrel"]:.3e}, {rec["passes"]} passes, {rec["vcycles"]} '
        f'V-cycles; interior residual {resid:.3e}; cold {rec["seconds"]:.3f}'
        f' s (potential phase), warm {warm[0]:.3f} / {warm[1]:.3f} s, '
        'bitwise equal; profiled warm solve: '
        f'{launches} launches = {launches / rec["vcycles"]:.0f} per '
        f'V-cycle, {device_ms:.1f} ms device in {prof_s:.3f} s; host direct '
        f'solve {direct_s:.3f} s, |refined - direct| max {diff.max():.4g} '
        f'mean {diff.mean():.4g} on {device_name}')
    hard = conductivity_hard(HARD_SHAPE, seed=1)
    got, hard_rrel, hard_stats, hard_s = _timed_solve(
        torch, torch.from_numpy(hard).cuda(), 0.)
    hard_err = float(np.abs(got.astype(np.float64) - solve_potential_direct(
        hard, 0.)).max())
    if not (hard_err < HARD_ERR_MAX and hard_rrel < RREL_MAX):
        fail(f'hard field {HARD_SHAPE}: max err {hard_err:.4g}, rrel '
             f'{hard_rrel:.3e}')
    say(f'solver, hard field {HARD_SHAPE[0]}x{HARD_SHAPE[1]}: max err '
        f'{hard_err:.4g} < {HARD_ERR_MAX} against direct, rrel '
        f'{hard_rrel:.3e}, {hard_stats["passes"]} passes, '
        f'{hard_stats["vcycles"]} V-cycles, {hard_s:.3f} s')
    return {'rrel': rec['rrel'], 'passes': rec['passes'],
            'vcycles': rec['vcycles'], 'interior_residual': resid,
            'cold_s': rec['seconds'], 'warm_s': warm,
            'profiled_launches': launches,
            'launches_per_vcycle': launches / rec['vcycles'],
            'profiled_device_ms': device_ms, 'profiled_wall_s': prof_s,
            'direct_s': direct_s, 'max_abs_vs_direct': float(diff.max()),
            'mean_abs_vs_direct': float(diff.mean()),
            'hard_460': {'max_abs_err': hard_err, 'rrel': hard_rrel,
                         'seconds': hard_s, **hard_stats}}


def _fresh(torch, state):
    """A copy of ``state`` with its own tensors and an empty map."""
    return dataclasses.replace(
        state, pos_r=state.pos_r.clone(), pos_c=state.pos_c.clone(),
        mem=state.mem.clone(), alive=state.alive.clone(),
        palive=state.palive.clone(),
        presence=torch.zeros_like(state.presence))


def _live_steps(before, after):
    """Live agent-steps of a run of chunk steps from state ``before`` to
    ``after``: the presence it added counts every pending agent once a
    step, that is ``before``'s pending agents and every live step but
    the last step's, which stays pending in ``after``."""
    added = int(after.presence.sum()) - int(before.presence.sum())
    return added - int(before.palive.sum()) + int(after.palive.sum())


def _once_ms(torch, fn):
    """(device ms, result) of one call to ``fn``, enqueued behind a GPU
    sleep so that the CUDA events see the device work and not the host's
    enqueue time (unless the enqueue outlasts the sleep)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def _state_diff(torch, a, b):
    """The first field in which two simulation states differ, or None."""
    for name in ('pos_r', 'pos_c', 'mem', 'alive', 'palive', 'presence'):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            return name
    return None if a.step == b.step else 'step'


def _chunk_segments(torch, state0, whole, chunk, u):
    """The CHUNK_T steps of ``chunk`` again as launches of CHUNK_SEG
    steps, each timed on the device: [(first step, end, ms, live
    agent-steps)]. The segmented run must end in ``whole``'s state."""
    st = _fresh(torch, state0)
    out = []
    for s0 in range(0, CHUNK_T, CHUNK_SEG):
        before = dataclasses.replace(st, presence=st.presence.clone(),
                                     palive=st.palive.clone())
        ms, st = _once_ms(torch, lambda: chunk(st, u=u[s0:s0 + CHUNK_SEG],
                                               s0=s0))
        out.append((s0, st.step, ms, _live_steps(before, st)))
    diff = _state_diff(torch, st, whole)
    if diff:
        fail(f'main field: the chunk in segments differs in {diff}')
    return out


def _run_table(torch, sim):
    """A uniform run's track parameters, directional bias, restriction
    table, table (rebuilt from its updraft and cached potential) and start
    cells, the tensors on the run's device."""
    from ssrs_tpu_torch.agents.moves import (directional_probs,
                                             restriction_table)
    from ssrs_tpu_torch.agents.simulate import prepared_weights
    dev = sim.device
    params = sim._track_params()
    case = sim.case_ids[0]
    ident = sim._get_id_string(case, 0)
    pot = torch.from_numpy(np.load(os.path.join(
        sim.mode_data_dir, f'{ident}_potential.npy'))).to(dev)
    dirp = torch.from_numpy(directional_probs(params.move_dirn)).to(dev)
    restr = torch.from_numpy(restriction_table()).to(dev)
    table = prepared_weights(sim.load_updrafts(case)[0].float(), pot, dirp,
                             params.weight_dtype)
    return params, dirp, restr, table, _run_starts(sim)


def _chunk_against_plain(torch, sim, label, run=None):
    """One CHUNK_T-step launch of the chunk kernel on ``sim``'s own table
    and starts (``run``, :func:`_run_table`'s, built when not given)
    against the plain version from the same state with the
    same uniforms, then the flush of the state after it against the plain
    flush: the states and maps must be exactly equal, and some points
    pending. Returns the largest difference of the maps (0), the agents,
    the live agent-steps, the visited cells and the pending points."""
    from ssrs_tpu_torch.agents.fused_chunk import (fused_chunk,
                                                   fused_chunk_plain)
    from ssrs_tpu_torch.agents.presence_hist import (presence_flush,
                                                     presence_flush_plain)
    from ssrs_tpu_torch.agents.simulate import init_state
    params, dirp, restr, table, starts = run or _run_table(torch, sim)
    state0 = init_state(params, starts, device=sim.device)
    n = state0.pos_r.shape[0]
    u = torch.rand((CHUNK_T, n), device=sim.device, generator=torch.Generator(
        device=sim.device).manual_seed(2032))
    runs = []
    for fn in (fused_chunk, fused_chunk_plain):
        st = _fresh(torch, state0)
        fn(table, restr, dirp, st.pos_r, st.pos_c, st.mem, st.alive,
           st.palive, u, st.presence, s0=0, nu=params.nu,
           memory_k=params.memory_k, burnin=params.burnin,
           nsteps=params.nsteps)
        runs.append(st)
    got, plain = runs
    err = int((got.presence - plain.presence).abs().max())
    diff = _state_diff(torch, got, plain)
    if diff:
        fail(f'{label}: the {CHUNK_T}-step chunk on the region\'s table '
             f'differs from the plain version in {diff}')
    maps = [got.presence.clone(), got.presence.clone()]
    flags = [presence_flush(got.pos_r, got.pos_c, got.palive, maps[0]),
             presence_flush_plain(got.pos_r, got.pos_c, got.palive, maps[1])]
    pending = int(got.palive.sum())
    if not pending or not torch.equal(*maps) or \
            not torch.equal(*flags) or torch.equal(maps[0], got.presence):
        fail(f'{label}: the flush after the chunk differs from the plain '
             'flush')
    return err, n, _live_steps(state0, got), int((got.presence > 0).sum()), \
        pending


def phase_chunk_main(torch, sim, device_name):
    """The chunk kernel on the main run's own table (rebuilt from its
    updraft and cached potential) and starts: one CHUNK_T-step launch
    against CHUNK_T per-step launches and the plain version from the same
    state with the same uniforms (exactly equal states), both kernels
    timed in turns (chunk, per-step, per-step, chunk), the chunk also in
    launches of CHUNK_SEG steps and at the recorded run's width; the
    uniform block timed on its own; a warm track phase, plain and
    profiled, equal to the run's counts; and the per-step driver
    (``simulate_presence``, the path of the fused step kernel) at the
    same width."""
    from ssrs_tpu_torch.agents.fused_chunk import (fused_chunk,
                                                   fused_chunk_plain)
    from ssrs_tpu_torch.agents.simulate import (
        init_state, make_step_fn, simulate_presence,
        simulate_presence_compacting)
    from ssrs_tpu_torch.core.rng import case_generator
    dev = sim.device
    case = sim.case_ids[0]
    params, dirp, restr, table, starts = _run_table(torch, sim)
    state0 = init_state(params, starts, device=dev)
    n = state0.pos_r.shape[0]
    gen = torch.Generator(device=dev).manual_seed(2030)
    u = torch.rand((CHUNK_T, n), generator=gen, device=dev)
    step = make_step_fn(params, table, dirp, restr)
    kw = dict(nu=params.nu, memory_k=params.memory_k,
              burnin=params.burnin, nsteps=params.nsteps)

    def chunk(st, fn=fused_chunk, u=u, s0=0):
        fn(table, restr, dirp, st.pos_r, st.pos_c, st.mem, st.alive,
           st.palive, u, st.presence, s0=s0, **kw)
        return dataclasses.replace(st, step=s0 + u.shape[0])

    def per_step(st):
        for t in range(CHUNK_T):
            st = step(st, u=u[t])
        return st

    runs, times = {}, {'chunk': [], 'per_step': []}
    for name in ('chunk', 'per_step', 'per_step', 'chunk'):
        fn = chunk if name == 'chunk' else per_step
        st = _fresh(torch, state0)
        dev_ms, runs[name] = _once_ms(torch, lambda: fn(st))
        st = _fresh(torch, state0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(st)
        torch.cuda.synchronize()
        times[name].append((dev_ms, (time.perf_counter() - t0) * 1e3))
    st = _fresh(torch, state0)
    plain_ms, runs['plain'] = _once_ms(
        torch, lambda: chunk(st, fused_chunk_plain))
    got = runs['chunk']
    for other in ('per_step', 'plain'):
        diff = _state_diff(torch, got, runs[other])
        if diff:
            fail(f'main field: the {CHUNK_T}-step chunk differs from '
                 f'{CHUNK_T} {other} steps in {diff}')
    live = _live_steps(state0, got)
    cells = int((got.presence > 0).sum())
    segments = _chunk_segments(torch, state0, got, chunk, u)
    # the flush of that state: what the driver's first compaction flushes
    flush_real = _flush_case(torch, got.pos_r, got.pos_c, got.palive,
                             got.presence,
                             f'the main field after {CHUNK_T} steps')
    # the recorded run's width: the first RECORDED_TRACKS starts, one
    # launch of CHUNK_T steps
    small0 = init_state(params, starts[:RECORDED_TRACKS], device=dev)
    st = _fresh(torch, small0)
    u_small = u[:, :RECORDED_TRACKS].contiguous()
    small_ms, st = _once_ms(torch, lambda: chunk(st, u=u_small))
    small = (small_ms, _live_steps(small0, st))
    bound_ms, bound_by = _chunk_bound(n, params.memory_k,
                                      9 * table.element_size(), live, cells)
    draw_ms = _device_ms(
        torch, lambda: torch.rand((CHUNK_T, n), generator=gen, device=dev),
        steps=20)
    ck = [t[0] for t in times['chunk']]
    cw = [t[1] for t in times['chunk']]
    sk = [t[0] for t in times['per_step']]
    sw = [t[1] for t in times['per_step']]
    say(f'main field chunk ({n} agents, {CHUNK_T} steps from step 0, '
        f'{str(table.dtype)[6:]} table, k={params.memory_k}, '
        f'nu={params.nu}): '
        f'exactly equal to {CHUNK_T} per-step launches and to the plain '
        f'version; {live} live agent-steps, {cells} cells. In turns: chunk '
        f'{ck[0]:.3f} ms device / {cw[0]:.3f} ms wall, per-step '
        f'{sk[0]:.3f} / {sw[0]:.3f} ms, per-step {sk[1]:.3f} / {sw[1]:.3f} '
        f'ms, chunk {ck[1]:.3f} / {cw[1]:.3f} ms (per-step device ms: CUDA '
        f'events around the enqueue, host gaps included); plain '
        f'{plain_ms:.1f} ms (the same); bound {bound_ms:.4f} ms '
        f'({bound_by}); uniform block ({CHUNK_T}, {n}) drawn in '
        f'{draw_ms:.3f} ms device on {device_name}')
    say(f'main field chunk in launches of {CHUNK_SEG} steps (device ms, '
        'live agent-steps, ps of device time per live agent-step): '
        + '; '.join(
            f'steps {a}-{b - 1}: {ms:.3f} ms, {n_live}, '
            f'{ms * 1e9 / max(n_live, 1):.1f}' for a, b, ms, n_live in
            segments) + f'; {RECORDED_TRACKS} agents, steps 0-{CHUNK_T - 1}: '
        f'{small[0]:.3f} ms, {small[1]}, {small[0] * 1e9 / small[1]:.1f}')

    # a warm track phase, plain and profiled: the run's generator gives
    # the run's counts
    counts = sim.get_presence_counts(case, 0)

    def track_phase():
        return simulate_presence_compacting(
            params, starts, case_generator(sim.sim_seed, case, 0, 'tracks',
                                           dev), base_flat=table, dirp=dirp)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    presence, steps = track_phase()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    profiled = []
    launches, device_ms, prof_s = _profile_launches(
        torch, lambda: profiled.append(track_phase()))
    for p_map, p_steps in ((presence, steps), profiled[0]):
        if p_steps != steps or not np.array_equal(p_map.cpu().numpy(),
                                                  counts):
            fail('main field: a warm track phase differs from the run')
    useful = int(counts.sum(dtype=np.int64)) - n
    say(f'warm track phase: {steps} steps in {warm_s:.3f} s = '
        f'{useful / warm_s:.4g} agent-steps/s, equal to the run; profiled: '
        f'{launches} launches = {launches / steps:.4f} per step, '
        f'{device_ms:.1f} ms device in {prof_s:.3f} s (busy '
        f'{device_ms / (prof_s * 1e3):.1%}) on {device_name}')

    # the per-step driver: the path of the fused step kernel
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    presence, ps_steps = simulate_presence(
        params, starts, torch.Generator(device=dev).manual_seed(2031),
        base_flat=table, dirp=dirp)
    torch.cuda.synchronize()
    ps_s = time.perf_counter() - t0
    per_step_path = _read_counts()
    mass = int(presence.sum())
    _check_flush_launches('per-step driver', per_step_path, flushes=1)
    if per_step_path['fused_step'] != ps_steps or \
            per_step_path['fused_chunk'] or mass < n * (params.burnin + 1):
        fail(f'per-step driver: {per_step_path} for {ps_steps} steps, mass '
             f'{mass}')
    say(f'per-step driver (simulate_presence, {n} agents): {ps_steps} steps '
        f'through {per_step_path["fused_step"]} fused step launches, 0 chunk '
        f'launches, {mass - n} agent-steps in {ps_s:.3f} s = '
        f'{(mass - n) / ps_s:.4g} agent-steps/s')
    return {
        'chunk_ms': float(np.median(ck)), 'chunk_wall_ms': cw,
        'chunk_device_ms': ck, 'per_step_device_ms': sk,
        'per_step_wall_ms': sw, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'live_agent_steps': live, 'cells': cells,
        'segments': [{'steps': [a, b], 'ms': ms, 'live_agent_steps': n_live}
                     for a, b, ms, n_live in segments],
        'chunk_ms_recorded_width': small[0],
        'live_agent_steps_recorded_width': small[1],
        'uniform_draw_ms': draw_ms, 'warm_track_s': warm_s,
        'warm_steps': steps, 'profiled_launches': launches,
        'launches_per_step': launches / steps,
        'profiled_device_ms': device_ms, 'profiled_wall_s': prof_s,
        'busy_share': device_ms / (prof_s * 1e3),
        'per_step_driver': {'steps': ps_steps, 'seconds': ps_s,
                            'agent_steps': mass - n},
        'flush_real': flush_real,
        'per_step_path_launches': per_step_path}


def _small_maps(torch, config):
    """The smoothed, normalized count maps of ``config`` on the card and
    through the plain versions on the CPU, on one potential: the CPU run
    reads the card run's cached potential from the shared out_dir (where
    the conductivity is high the potential is flat to float32 ulps, so
    two potentials that differ by ulps alone move the maps apart by more
    than sampling noise)."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents import smooth_presence
    maps = []
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        for device in ('cuda', 'cpu'):
            sim = Simulator(Config(out_dir=out, **config), device=device)
            sim.simulate_tracks()
            rec = {r['phase']: r for r in sim.timer.records}['tracks']
            if rec['recorded'] != (sim.track_count <= sim.track_pkl_budget):
                fail(f'small run on {device}: recorded={rec["recorded"]}')
            counts = sim.get_presence_counts(sim.case_ids[0], 0)
            smooth = smooth_presence(torch.from_numpy(counts), 3).numpy()
            maps.append(smooth.astype(np.float64) / smooth.sum())
    return float(np.abs(maps[0] - maps[1]).sum())


def phase_small(torch):
    """The small WY run, card against CPU: counts alone, then with
    recorded tracks (the default budget)."""
    recorded = {k: v for k, v in SMALL_CONFIG.items()
                if k != 'track_pkl_budget'}
    for label, config in (('small run', SMALL_CONFIG),
                          ('small recorded run', recorded)):
        l1 = _small_maps(torch, config)
        if not l1 < L1_BOUND:
            fail(f'{label}: card vs CPU L1 {l1:.4f} >= {L1_BOUND}')
        say(f'{label}: card vs CPU plain versions L1 {l1:.4f} < {L1_BOUND}')


def _dict_live_steps(before, after, pres):
    """Live agent-steps of a chunk from the state ``before`` to ``after``
    (dicts of tensors) that added ``pres`` to an empty map: every pending
    agent counts once a step, so the map holds ``before``'s pending agents
    and every live step but the last step's, which stays pending."""
    return int(pres.sum()) - int(before['palive'].sum()) \
        + int(after['palive'].sum())


def phase_no_table(torch):
    """The directed random walk's branch of both kernels (a null table
    pointer) against their plain versions on the card, N=100k on 500x600:
    k in {0, 1, 3} at nu = 1 exact (the per-step kernel's outputs and
    counts; the chunk kernel's state, counts and emission rows over
    CHUNK_T steps from before the burn-in's end), nu = 2 >= 99.9% of
    moves; the k = 1 chunk timed beside its plain version and its bound."""
    from ssrs_tpu_torch.agents.fused_chunk import (fused_chunk,
                                                   fused_chunk_plain)
    from ssrs_tpu_torch.agents.fused_step import (fused_step,
                                                  fused_step_plain)
    from ssrs_tpu_torch.agents.moves import (directional_probs,
                                             restriction_table)
    dev = torch.device('cuda')
    restr = torch.from_numpy(restriction_table()).to(dev)
    dirp = torch.from_numpy(directional_probs(30.)).to(dev)
    rng = np.random.default_rng(2032)
    gen = torch.Generator(device=dev).manual_seed(2032)
    burnin = min(NROW, NCOL) // 10
    max_err = 0
    out = {}

    def step(fn, a, pres, nu, k):
        return fn(None, restr, dirp, a['pr'], a['pc'], a['r'], a['c'],
                  a['alive'], a['palive'], a['mem'], a['u'], pres, nu=nu,
                  memory_k=k)

    def chunk(fn, st, u, pres, nu, k, emit):
        fn(None, restr, dirp, st['r'], st['c'], st['mem'], st['alive'],
           st['palive'], u, pres, nu=nu, memory_k=k, s0=CHUNK_S0,
           burnin=burnin, nsteps=10_000, emit=emit)

    for k in (0, 1, 3):
        _, a = _step_inputs(torch, rng, torch.float32, dev)
        a['mem'] = torch.from_numpy(
            rng.integers(0, 9, (max(k, 1), N_AGENTS)).astype(np.int32)
        ).to(dev)
        pres_k = torch.zeros(NROW, NCOL, dtype=torch.int32, device=dev)
        pres_p = torch.zeros_like(pres_k)
        out_k = step(fused_step, a, pres_k, 1.0, k)
        out_p = step(fused_step_plain, a, pres_p, 1.0, k)
        st_k = _chunk_state(torch, rng, k, dev)
        st_p = {name: v.clone() for name, v in st_k.items()}
        before = {name: v.clone() for name, v in st_k.items()}
        u = torch.rand((CHUNK_T, N_AGENTS), generator=gen, device=dev)
        emit_k = _emission(torch, CHUNK_T, -7, dev)
        emit_p = _emission(torch, CHUNK_T, 11, dev)
        cpres_k, cpres_p = torch.zeros_like(pres_k), torch.zeros_like(pres_k)
        chunk(fused_chunk, st_k, u, cpres_k, 1.0, k, emit_k)
        t0 = time.perf_counter()
        chunk(fused_chunk_plain, st_p, u, cpres_p, 1.0, k, emit_p)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        pairs = list(zip(('new_r', 'new_c', 'new_mem'), out_k, out_p))
        pairs += [('step presence', pres_k, pres_p),
                  ('chunk presence', cpres_k, cpres_p),
                  ('emitted positions', emit_k[0], emit_p[0]),
                  ('emitted flags', emit_k[1], emit_p[1])]
        pairs += [(name, st_k[name], st_p[name]) for name in st_k]
        for name, x, y in pairs:
            err = int((x.long() - y.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                fail(f'no table, k={k}: {name} differs from plain (max abs '
                     f'err {err})')
        if int(cpres_k.sum()) <= 0 or int(pres_k.sum()) <= 0:
            fail(f'no table, k={k}: nothing was counted')
        say(f'no-table kernels k={k} nu=1: per-step and chunk (T={CHUNK_T} '
            f'from step {CHUNK_S0}, emission rows) exact match with plain '
            f'(N={N_AGENTS}, {NROW}x{NCOL}; '
            f'{int(st_k["alive"].sum())} alive after)')
        if k == 1:
            live = _dict_live_steps(before, st_k, cpres_k)
            cells = int((cpres_k > 0).sum())

            def timed():
                st = {name: v.clone() for name, v in before.items()}
                pres = torch.zeros_like(cpres_k)
                return _once_ms(torch, lambda: chunk(fused_chunk, st, u,
                                                     pres, 1.0, 1, None))[0]

            ms = float(np.median([timed() for _ in range(5)]))
            bound_ms, bound_by = _chunk_bound(N_AGENTS, 1, 0, live, cells)
            out = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                   'bound_by': bound_by, 'live_agent_steps': live,
                   'cells': cells, 'steps': CHUNK_T}
            say(f'no-table chunk k=1 ({live} live agent-steps, {cells} '
                f'cells): {ms:.3f} ms device, plain {plain_ms:.1f} ms wall, '
                f'bound {bound_ms:.4f} ms ({bound_by})')
    # nu = 2
    _, a = _step_inputs(torch, rng, torch.float32, dev)
    pres_k = torch.zeros(NROW, NCOL, dtype=torch.int32, device=dev)
    pres_p = torch.zeros_like(pres_k)
    out_k = step(fused_step, a, pres_k, 2.0, 1)
    out_p = step(fused_step_plain, a, pres_p, 2.0, 1)
    st_k = _chunk_state(torch, rng, 1, dev)
    st_p = {name: v.clone() for name, v in st_k.items()}
    u = torch.rand((1, N_AGENTS), generator=gen, device=dev)
    cpres_k, cpres_p = torch.zeros_like(pres_k), torch.zeros_like(pres_k)
    chunk(fused_chunk, st_k, u, cpres_k, 2.0, 1, None)
    chunk(fused_chunk_plain, st_p, u, cpres_p, 2.0, 1, None)
    torch.cuda.synchronize()
    fracs = [float(((x[0] == y[0]) & (x[1] == y[1])).to(torch.float64).mean())
             for x, y in ((out_k, out_p), ((st_k['r'], st_k['c']),
                                           (st_p['r'], st_p['c'])))]
    if min(fracs) < NU2_MIN_EQUAL or not torch.equal(pres_k, pres_p) or \
            not torch.equal(cpres_k, cpres_p):
        fail(f'no table, nu=2: {fracs} of moves equal, or the presence '
             'differs')
    say(f'no-table kernels nu=2: per-step {fracs[0]:.6f}, chunk (T=1) '
        f'{fracs[1]:.6f} of moves equal (>= {NU2_MIN_EQUAL}), presence '
        'exact')
    out['max_abs_err'] = max_err
    return out


def phase_thermals(torch, sim):
    """The thermal field's two pieces on the card at 500x600: the Gaussian
    filter (two float32 convolutions of 33 taps; called with TF32 allowed,
    which it must turn off itself) against the CPU on one numpy-seeded
    field, to GAUSS_TOL of the field's maximum; and
    ``compute_thermals`` on the main run's aspect: the outer 10% less the
    filter's 16 cells exactly zero, and the mean sum of THERMAL_SEEDS
    fields within THERMAL_MASS_TOL of the seeds' expected mass (the filter
    loses none; one field's sum scatters by ~12%, the mean of 8 by ~4%)."""
    from ssrs_tpu_torch.core.rng import case_generator
    from ssrs_tpu_torch.fields import compute_thermals, gaussian_filter
    dev = sim.device
    rng = np.random.default_rng(2033)
    field = torch.from_numpy(
        (rng.random((NROW, NCOL)) ** 8 * 40.).astype(np.float32))
    # with TF32 allowed around the call: the filter turns it off itself
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = gaussian_filter(field.to(dev))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    want = gaussian_filter(field)
    err = float((got.cpu() - want).abs().max())
    if not err <= GAUSS_TOL * float(field.max()):
        fail(f'gaussian_filter: card vs CPU max abs err {err:.3e} > '
             f'{GAUSS_TOL} x {float(field.max()):.3g}')
    ms = _device_ms(torch, lambda: gaussian_filter(got), steps=20)
    aspect = sim._slope_aspect()[1]
    scale = 2.0
    by, bx = int(0.1 * NROW), int(0.1 * NCOL)
    wt = torch.floor(1000. + (aspect[by:-by, bx:-bx].double() - 180.).abs()
                     / 180. * 2000.)
    expected = float((1. / (wt - 1.)).sum()) * math.exp(scale + 3. + 0.125)
    sums = []
    for real in range(THERMAL_SEEDS):
        gen = case_generator(sim.sim_seed, 'smoke', real, 'thermals', dev)
        th = compute_thermals(gen, aspect, scale)
        inner = torch.zeros_like(th, dtype=torch.bool)
        edge_y, edge_x = max(by - 16, 0), max(bx - 16, 0)
        inner[edge_y:NROW - edge_y, edge_x:NCOL - edge_x] = True
        if th.shape != (NROW, NCOL) or not torch.isfinite(th).all() or \
                float(th.min()) < 0. or bool(th[~inner].any()):
            fail('compute_thermals: the field is not finite, non-negative '
                 'and zero on the border')
        sums.append(float(th.double().sum()))
    gen = case_generator(sim.sim_seed, 'smoke', 0, 'thermals', dev)
    if float(compute_thermals(gen, aspect, scale).double().sum()) != sums[0]:
        fail('compute_thermals: the same seed gave another field')
    ratio = float(np.mean(sums)) / expected
    if abs(ratio - 1.) > THERMAL_MASS_TOL:
        fail(f'compute_thermals: mean mass {np.mean(sums):.4g} over '
             f'{THERMAL_SEEDS} seeds is {ratio:.3f} of the expected '
             f'{expected:.4g}')
    say(f'thermals: gaussian_filter {NROW}x{NCOL} card vs CPU max abs err '
        f'{err:.3e} <= {GAUSS_TOL} x max, {ms * 1e3:.1f} us device; '
        f'compute_thermals on the run\'s aspect: border exactly zero, mean '
        f'mass of {THERMAL_SEEDS} seeds {ratio:.3f} of the expected '
        f'{expected:.4g} (within {THERMAL_MASS_TOL}), a seed reproduces')
    return {'gaussian_filter_err': err, 'gaussian_filter_ms': ms,
            'thermal_mass_ratio': ratio}


def _check_case_counts(label, counts, tracks, burnin):
    if counts.shape != (NROW, NCOL) or counts.dtype != np.int32 or \
            not np.isfinite(counts).all() or counts.min() < 0:
        fail(f'{label}: counts are not a finite non-negative int32 '
             f'{NROW}x{NCOL} map')
    total = int(counts.sum(dtype=np.int64))
    if total < tracks * (burnin + 1):
        fail(f'{label}: presence mass {total} < {tracks * (burnin + 1)}')
    return total


def _check_batched_launches(label, launched, rec):
    """The cases driver's launches: one chunk launch a chunk of every case
    (each chunk, at most 100,000 agents x DRIVER_CHUNK steps, is one
    uniform block), no per-step launch, one flush launch a flush."""
    chunks = sum(math.ceil(s / DRIVER_CHUNK) for s in rec['steps'])
    if launched['fused_chunk'] != chunks or launched['fused_step'] or \
            launched['fused_chunk_steps'] != sum(rec['steps']):
        fail(f'{label}: {launched["fused_chunk"]} chunk launches covering '
             f'{launched["fused_chunk_steps"]} steps and '
             f'{launched["fused_step"]} per-step launches for steps '
             f'{rec["steps"]} ({chunks} chunks)')
    _check_flush_launches(label, launched)


def _solver_line(rec):
    s = rec['solver'] + (' -> direct (fallback)' if rec['fallback'] else '')
    if rec['rrel'] is not None:
        s += f' rrel {rec["rrel"]:.2e}'
    return f'{rec["id"].split("_")[0]} {s} {rec["seconds"]:.2f} s'


def _check_cases_against_single(torch, sim, label, starts, rec, counts,
                                picks):
    """The batched run of ``sim``'s cases (realization 0 of each) against
    the single-case driver: every table of one batched build from the
    saved fields equals its own build, and the cases ``picks`` give, from
    the same table, starts and generator, the steps and the counts of the
    batched run, bit for bit. Returns the tables."""
    from ssrs_tpu_torch.agents.moves import directional_probs
    from ssrs_tpu_torch.agents.simulate import (
        prepared_weights, prepared_weights_batch,
        simulate_presence_compacting)
    from ssrs_tpu_torch.core.rng import case_generator
    dev = sim.device
    cases = sim.case_ids
    params = sim._track_params()
    dirp = torch.from_numpy(directional_probs(params.move_dirn)).to(dev)
    ups = torch.stack([sim.load_updrafts(c)[0] for c in cases])
    potentials = torch.stack([torch.from_numpy(np.load(os.path.join(
        sim.mode_data_dir,
        f'{sim._get_id_string(c, 0)}_potential.npy'))).to(dev)
        for c in cases])
    tables = prepared_weights_batch(ups, potentials,
                                    dirp.expand(len(cases), 9),
                                    params.weight_dtype)
    for i in range(len(cases)):
        single = prepared_weights(ups[i], potentials[i], dirp,
                                  params.weight_dtype)
        if not torch.equal(tables[i].view(torch.int16),
                           single.view(torch.int16)):
            fail(f'{label}: table {i} of the batched build differs from '
                 'its own build')
    for i in picks:
        got, steps = simulate_presence_compacting(
            params, starts, case_generator(sim.sim_seed, cases[i], 0,
                                           'tracks', dev),
            base_flat=tables[i], dirp=dirp)
        if steps != rec['steps'][i] or \
                not np.array_equal(got.cpu().numpy(), counts[i]):
            fail(f'{label}: case {cases[i]} differs from the single-case '
                 'compacting driver')
    say(f'{label}: cases {[cases[i] for i in picks]} bit-identical to '
        'simulate_presence_compacting with the same seed, table and '
        f'starts; the {len(cases)} batched tables equal their own builds')
    return tables


def phase_sweep(torch, device_name, out):
    """The direction sweep: SWEEP_DIRNS at the README region's width,
    100,000 tracks a direction, through ``simulate_direction_sweep``."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents.simulate import \
        simulate_presence_cases_compacting
    from ssrs_tpu_torch.core.rng import case_generator
    cfg = Config(out_dir=out, **{**MAIN_CONFIG, 'run_name': 'wy_sweep'})
    sim = Simulator(cfg)
    dev = sim.device
    n_cases = len(SWEEP_DIRNS)
    tracks = cfg.track_count
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cases = sim.simulate_direction_sweep(SWEEP_DIRNS)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launched = _read_counts()
    if cases != [f's10d{int(d)}' for d in SWEEP_DIRNS]:
        fail(f'sweep: case ids {cases}')
    pots = [r for r in sim.timer.records if r['phase'] == 'potential']
    recs = [r for r in sim.timer.records if r['phase'] == 'batched_tracks']
    if len(pots) != n_cases or len(recs) != 1 or \
            recs[0]['cases'] != n_cases or \
            any(r['solver'] not in ('refined', 'direct') for r in pots):
        fail(f'sweep: {len(pots)} potential records, batched records {recs}')
    rec = recs[0]
    _check_batched_launches('sweep', launched, rec)
    burnin = sim.grid.burnin_length()

    def load(case, kind):
        return np.load(os.path.join(
            sim.mode_data_dir, f'{sim._get_id_string(case, 0)}_{kind}.npy'))

    counts = {c: load(c, 'counts') for c in cases}
    mass = sum(_check_case_counts(f'sweep {c}', counts[c], tracks, burnin)
               for c in cases)
    if rec['useful_steps'] != mass - n_cases * tracks:
        fail(f'sweep: useful_steps {rec["useful_steps"]} != '
             f'{mass - n_cases * tracks}')
    for c in cases:
        if not os.path.isfile(os.path.join(sim.mode_data_dir,
                                           f'{c}_orograph.npy')):
            fail(f'sweep: {c}_orograph.npy is missing')
    prep_s = sum(r['seconds'] for r in pots)
    rounds = max(math.ceil(s / DRIVER_CHUNK) for s in rec['steps'])
    say('sweep potentials: ' + '; '.join(_solver_line(r) for r in pots))
    say(f'sweep: {n_cases} directions x {tracks} tracks in {sweep_s:.3f} s: '
        f'potentials {prep_s:.3f} s, batched track phase '
        f'{rec["seconds"]:.3f} s for {rec["useful_steps"]} agent-steps = '
        f'{rec["useful_steps"] / rec["seconds"]:.4g} agent-steps/s; steps '
        f'{rec["steps"]}, {rounds} rounds, {launched["fused_chunk"]} chunk '
        f'launches ({launched["fused_chunk"] / rounds:.2f} a round), '
        f'{launched["flushes"]} flushes through '
        f'{launched["presence_flush"]} flush launches, 0 per-step launches '
        f'on {device_name}')

    # the first case, and one whose potential came from the fallback (or
    # 225 degrees, where the refined solve stalled on the tests' field)
    fallen = [i for i, r in enumerate(pots) if r['fallback'] and i > 0]
    picks = [0, (fallen + [n_cases // 2 + 1])[0]]
    params = sim._track_params()
    starts = _run_starts(cfg)
    tables = _check_cases_against_single(
        torch, sim, 'sweep', starts, rec, [counts[c] for c in cases], picks)

    # the batched track phase again, warm, twice timed and once profiled;
    # every result equal to the sweep's
    def batched():
        gens = [case_generator(cfg.sim_seed, c, 0, 'tracks', dev)
                for c in cases]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        presence, steps = simulate_presence_cases_compacting(
            params, tables, starts, gens)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, presence, steps

    def checked(run):
        secs, presence, steps = run
        presence = presence.cpu().numpy()
        if list(steps) != rec['steps'] or any(
                not np.array_equal(presence[i], counts[c])
                for i, c in enumerate(cases)):
            fail('sweep: the warm batched phase differs from the sweep')
        return secs

    warm = [checked(batched()) for _ in range(2)]
    run = []
    launches, device_ms, prof_s = _profile_launches(
        torch, lambda: run.append(batched()))
    checked(run[0])
    profiled = {
        'launches': launches, 'device_ms': device_ms, 'wall_s': prof_s,
        'busy_share': device_ms / (prof_s * 1e3),
        'launches_per_round': launches / rounds}
    useful = rec['useful_steps']
    say(f'sweep, warm batched track phase (s): {warm[0]:.4f}, '
        f'{warm[1]:.4f} = {useful / min(warm):.4g} agent-steps/s; '
        f'bit-identical to the sweep. Profiled: {launches} launches '
        f'({profiled["launches_per_round"]:.1f} a round), '
        f'{device_ms:.1f} ms device in {prof_s:.3f} s (busy '
        f'{profiled["busy_share"]:.1%}) on {device_name}')

    # a rerun: every potential from the cache, equal counts
    sim._rng = np.random.default_rng(cfg.sim_seed)
    n_before = len(sim.timer.records)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.simulate_direction_sweep(SWEEP_DIRNS)
    torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    again = [r for r in sim.timer.records[n_before:]
             if r['phase'] == 'potential']
    hits = sum(r['solver'] == 'cache' for r in again)
    if hits != n_cases or any(
            not np.array_equal(load(c, 'counts'), counts[c]) for c in cases):
        fail(f'sweep rerun: {hits} cache hits of {n_cases}, or the counts '
             'differ')
    rerun = [r for r in sim.timer.records[n_before:]
             if r['phase'] == 'batched_tracks'][0]
    say(f'sweep rerun: {hits} cache hits, equal counts, {rerun_s:.3f} s '
        f'(batched track phase {rerun["seconds"]:.3f} s)')
    sim.compute_presence_map()
    return launched, {
        'directions': list(SWEEP_DIRNS), 'sweep_s': sweep_s,
        'potentials_s': prep_s,
        'potentials': [{k: r[k] for k in ('id', 'solver', 'fallback', 'rrel',
                                          'seconds', 'vcycles')}
                       for r in pots],
        'batched_tracks_s': rec['seconds'], 'useful_steps': useful,
        'steps': rec['steps'], 'rounds': rounds,
        'chunk_launches': launched['fused_chunk'],
        'flushes': launched['flushes'], 'warm_s': warm,
        'profiled': profiled, 'rerun_s': rerun_s,
        'rerun_batched_tracks_s': rerun['seconds']}


def _batched_vcycle_launches(torch, conds, dirn):
    """(launches, device ms) of one V-cycle of the refined solver's level
    hierarchy of ``conds``, a (C, nrow, ncol) batch on the card or one
    field, under torch.profiler."""
    from ssrs_tpu_torch.potential import lap
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    bmask, _ = boundary_masks(dirn, tuple(conds.shape[-2:]))
    labels, k = lap.batch_island_labels(
        (conds > 0).reshape(-1, *conds.shape[-2:]).cpu().numpy(), bmask)
    levels = lap.build_lap_levels(
        lap.symmetrize_planes(lap.weight_planes(conds)),
        torch.from_numpy(bmask).cuda(), labels.reshape(conds.shape), k + 1)
    rhs = torch.rand(conds.shape, device=conds.device)
    lap.vcycle(levels, rhs, torch.zeros_like(rhs))
    launches, device_ms, _ = _profile_launches(
        torch, lambda: lap.vcycle(levels, rhs, torch.zeros_like(rhs)))
    return launches, device_ms


def _check_potential(label, pot, cond, dirn):
    """The invariants of the reference's system on a saved potential: the
    float64 interior residual, the range and the exact boundary. Returns
    the residual."""
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    from ssrs_tpu_torch.potential.direct import interior_residual
    bmask, bvals = boundary_masks(dirn, pot.shape)
    resid = interior_residual(pot, cond, dirn)
    if not resid <= INTERIOR_RESID_MAX:
        fail(f'{label}: interior residual {resid:.3e} > '
             f'{INTERIOR_RESID_MAX}')
    if pot.min() < -RANGE_SLACK or pot.max() > 1000. + RANGE_SLACK or \
            not np.array_equal(pot[bmask], bvals[bmask]):
        fail(f'{label}: potential range {pot.min()}..{pot.max()} or its '
             'boundary is off')
    return resid


def phase_solver_options(torch, device_name, out, main_sim, main_saved,
                         solver, sweep):
    """The solver options at the README region's width: the direction
    sweep with its eight potentials in one batched solve
    (``potential_batch``), against ``phase_sweep``'s single solves; the
    460x460 hard field in a batch of four; the legacy multigrid
    (``potential_solver='mg'``) on the hard field and in a uniform run;
    the self-tuned tail (``track_tail_bucket='auto'``) in a uniform run
    on the main run's cached potential. Returns the launches of the three
    runs, each counted from 0 just before it, and the phase's numbers."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents import simulate as tsim
    from ssrs_tpu_torch.potential import (boundary_masks,
                                          solve_potential_direct,
                                          solve_potential_for_direction,
                                          solve_potential_refined_batch)
    from ssrs_tpu_torch.potential.fields import conductivity_hard
    launched = {}

    # the batched sweep
    cfg = Config(out_dir=out, **{**MAIN_CONFIG, 'run_name': 'wy_sweep_batch',
                                 'potential_batch': BATCH_SWEEP})
    sim = Simulator(cfg)
    if sim._potential_batch_cap() < BATCH_SWEEP:
        fail(f'batched sweep: cap {sim._potential_batch_cap()} < '
             f'{BATCH_SWEEP}')
    tracks = cfg.track_count
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cases = sim.simulate_direction_sweep(SWEEP_DIRNS)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launched['batched_sweep'] = _read_counts()
    pots = [r for r in sim.timer.records if r['phase'] == 'potential']
    rec = [r for r in sim.timer.records if r['phase'] == 'batched_tracks'][0]
    if len(pots) != len(SWEEP_DIRNS) or \
            any(r.get('batch') != BATCH_SWEEP for r in pots):
        fail(f'batched sweep: records {pots}')
    _check_batched_launches('batched sweep', launched['batched_sweep'], rec)
    burnin = sim.grid.burnin_length()
    dirn = float(sim.track_direction)
    conds, saved = [], []
    for r, c in zip(pots, cases):
        if not (r['rrel'] < RREL_MAX or r['fallback']):
            fail(f'batched sweep {c}: rrel {r["rrel"]:.3e} and no fallback')
        cond = sim.load_updrafts(c)[0]
        conds.append(cond)
        saved.append(np.load(os.path.join(
            sim.mode_data_dir, f'{sim._get_id_string(c, 0)}_potential.npy')))
        r['interior_residual'] = _check_potential(
            f'batched sweep {c}', saved[-1], cond.cpu().numpy(), dirn)
        _check_case_counts(f'batched sweep {c}', np.load(os.path.join(
            sim.mode_data_dir, f'{sim._get_id_string(c, 0)}_counts.npy')),
            tracks, burnin)
    # the group again, bitwise, its memory measured
    bmask, bvals = boundary_masks(dirn, (NROW, NCOL))
    group = torch.stack(conds)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, rrels = solve_potential_refined_batch(
        group, bmask, bvals, tol=float(cfg.potential_tol))
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    again = again.cpu().numpy()
    for i, r in enumerate(pots):
        if float(rrels[i]) != r['rrel'] or (
                not r['fallback'] and not np.array_equal(again[i], saved[i])):
            fail(f'batched sweep {cases[i]}: a second batched solve is not '
                 'bitwise equal')
    launches_b, device_ms_b = _batched_vcycle_launches(torch, group, dirn)
    launches_1, device_ms_1 = _batched_vcycle_launches(torch, conds[0], dirn)
    solo = sweep['potentials']
    solo_s = sum(r['seconds'] for r in solo)
    group_s = pots[0]['group_seconds']
    say('batched sweep potentials (batched / single): ' + '; '.join(
        f'{c} rrel {b["rrel"]:.2e} / {a["rrel"]:.2e}, V-cycles '
        f'{b["vcycles"]} / {a["vcycles"]}, {b["seconds"]:.2f} / '
        f'{a["seconds"]:.2f} s' + (' (fallback)' if b['fallback'] else '')
        for c, b, a in zip(cases, pots, solo)))
    say(f'batched sweep: {len(cases)} directions x {tracks} tracks in '
        f'{sweep_s:.3f} s; one group of {BATCH_SWEEP} solved in '
        f'{group_s:.3f} s (again {again_s:.3f} s, bitwise equal) against '
        f'{solo_s:.3f} s for the sweep\'s eight single solves = '
        f'{solo_s / group_s:.2f}x; peak {peak / 2**20:.1f} MiB = '
        f'{peak / (BATCH_SWEEP * NROW * NCOL):.0f} B a cell and case; one '
        f'batched V-cycle {launches_b} launches, {device_ms_b:.2f} ms device '
        f'(one field: {launches_1}, {device_ms_1:.2f} ms); counts, '
        f'{launched["batched_sweep"]["fused_chunk"]} chunk launches on '
        f'{device_name}')
    batched = {
        'sweep_s': sweep_s, 'group_s': group_s, 'again_s': again_s,
        'single_solves_s': solo_s, 'peak_bytes': peak,
        'peak_bytes_per_cell_case': peak / (BATCH_SWEEP * NROW * NCOL),
        'vcycle_launches': launches_b, 'vcycle_device_ms': device_ms_b,
        'single_vcycle_launches': launches_1,
        'single_vcycle_device_ms': device_ms_1,
        'cases': [{k: r.get(k) for k in (
            'id', 'rrel', 'fallback', 'passes', 'vcycles', 'seconds',
            'interior_residual')} for r in pots]}

    # the hard field in a batch of four
    hards = [conductivity_hard(HARD_SHAPE, seed=s) for s in HARD_BATCH_SEEDS]
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hpots, hrrels = solve_potential_refined_batch(
        torch.from_numpy(np.stack(hards)).cuda(), *boundary_masks(
            0., HARD_SHAPE), stats=stats)
    torch.cuda.synchronize()
    hard_s = time.perf_counter() - t0
    hard_err = float(np.abs(hpots[0].cpu().numpy().astype(np.float64) -
                            solve_potential_direct(hards[0], 0.)).max())
    if not (hard_err < HARD_ERR_MAX and hrrels[0] < RREL_MAX):
        fail(f'hard field in a batch: max err {hard_err:.4g}, rrel '
             f'{hrrels[0]:.3e}')
    say(f'hard field {HARD_SHAPE[0]}x{HARD_SHAPE[1]} in a batch of '
        f'{len(hards)} (seeds {HARD_BATCH_SEEDS}): max err {hard_err:.4g} < '
        f'{HARD_ERR_MAX} against direct (alone: '
        f'{solver["hard_460"]["max_abs_err"]:.4g}); rrel '
        f'{", ".join(f"{r:.2e}" for r in hrrels)}; V-cycles '
        f'{stats["vcycles"]} (alone: {solver["hard_460"]["vcycles"]}); '
        f'{hard_s:.3f} s (alone: {solver["hard_460"]["seconds"]:.3f} s)')
    hard = {'max_abs_err': hard_err, 'rrel': [float(r) for r in hrrels],
            'seconds': hard_s, **stats}

    # the legacy multigrid: the tests' field and the hard field, then a run
    mg = {}
    for label, cond, bound in (
            ('tests field', conductivity_hard(MG_SHAPE, seed=1), None),
            ('hard field', hards[0], MG_HARD_RESID * MG_RESID_SLACK)):
        bm, bv = boundary_masks(0., cond.shape)
        if bound is None:
            bound = 1e-7 * float(np.linalg.norm(bv)) + 1e-2
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pot, resid = solve_potential_for_direction(
            torch.from_numpy(cond).cuda(), 0., tol=1e-7, maxiter=300,
            stats=stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pot = pot.cpu().numpy()
        if not resid < bound or pot.min() < -1. or pot.max() > 1001. or \
                not np.array_equal(pot[bm], bv[bm]):
            fail(f'mg, {label}: residual norm {resid:.4g} (bound '
                 f'{bound:.4g}), range {pot.min()}..{pot.max()}, or the '
                 'boundary is off')
        mg[label] = {'residual_norm': resid, 'bound': bound,
                     'seconds': secs, **stats}
    cfg = Config(out_dir=out, **{**MAIN_CONFIG, 'run_name': 'wy_mg',
                                 'potential_solver': 'mg'})
    mg_sim = Simulator(cfg)
    _reset_counts()
    mg_sim.simulate_tracks()
    launched['mg_run'] = _read_counts()
    records = {r['phase']: r for r in mg_sim.timer.records}
    _check_chunk_launches('mg run', launched['mg_run'],
                          records['tracks']['steps'])
    _check_flush_launches('mg run', launched['mg_run'])
    counts = mg_sim.get_presence_counts(mg_sim.case_ids[0], 0)
    _check_case_counts('mg run', counts.astype(np.int32), tracks,
                       mg_sim.grid.burnin_length())
    prec = records['potential']
    if prec['solver'] != 'mg' or prec['fallback']:
        fail(f'mg run: potential record {prec}')
    mg['run'] = {k: prec[k] for k in ('seconds', 'vcycles', 'residual_norm')}
    mg['run']['tracks_s'] = records['tracks']['seconds']
    say(f'mg: tests field {MG_SHAPE} residual norm '
        f'{mg["tests field"]["residual_norm"]:.4g} < '
        f'{mg["tests field"]["bound"]:.4g}; hard field residual norm '
        f'{mg["hard field"]["residual_norm"]:.4g} < '
        f'{mg["hard field"]["bound"]:.4g} after '
        f'{mg["hard field"]["vcycles"]} V-cycles in '
        f'{mg["hard field"]["seconds"]:.3f} s; uniform run: '
        f'{prec["vcycles"]} V-cycles in {prec["seconds"]:.3f} s (residual '
        f'norm {prec["residual_norm"]:.4g}), tracks '
        f'{records["tracks"]["seconds"]:.3f} s, counts checked')

    # the self-tuned tail, on the main run's cached potential
    cfg = Config(out_dir=out, **{**MAIN_CONFIG, 'run_name': 'wy_auto',
                                 'track_tail_bucket': 'auto'})
    auto_sim = Simulator(cfg)
    ident = main_sim._get_id_string(main_sim.case_ids[0], 0)
    shutil.copy(os.path.join(main_sim.mode_data_dir,
                             f'{ident}_potential.npy'), auto_sim.mode_data_dir)
    buckets = []
    real = tsim._compact_body

    def spy(state, m):
        buckets.append(m)
        return real(state, m)

    tsim._compact_body = spy
    _reset_counts()
    try:
        auto_sim.simulate_tracks()
    finally:
        tsim._compact_body = real
    launched['auto_run'] = _read_counts()
    records = {r['phase']: r for r in auto_sim.timer.records}
    if records['potential']['solver'] != 'cache':
        fail('auto run: the potential was not taken from the cache')
    steps = records['tracks']['steps']
    _check_chunk_launches('auto run', launched['auto_run'], steps)
    _check_flush_launches('auto run', launched['auto_run'])
    counts = auto_sim.get_presence_counts(auto_sim.case_ids[0], 0)
    mass = _check_case_counts('auto run', counts.astype(np.int32), tracks,
                              auto_sim.grid.burnin_length())
    if mass != records['tracks']['useful_steps'] + tracks:
        fail(f'auto run: counts {mass} != the map\'s mass '
             f'{records["tracks"]["useful_steps"] + tracks}')
    # the rule only ever stops compaction: a run that packed nothing, or
    # packed down to min_bucket, ran tail 0's buckets, so its counts are
    # the main run's (saved before the recorded run took its file name)
    same = not buckets or buckets[-1] == AUTO_MIN_BUCKET
    if same and not np.array_equal(counts, main_saved['counts']):
        fail('auto run: tail 0\'s buckets but not the main run\'s counts')
    params = auto_sim._track_params()
    rtt = tsim._dispatch_overhead(auto_sim.device)
    per_slot = tsim._PER_SLOT.get((params, DRIVER_CHUNK,
                                   auto_sim.device.type))
    main_tracks = {r['phase']: r for r in main_sim.timer.records}['tracks']
    auto = {'rtt_s': rtt, 'per_slot_s': per_slot, 'buckets': buckets,
            'counts_equal_tail0': same,
            'stopped_at': buckets[-1] if buckets else None, 'steps': steps,
            'chunk_launches': launched['auto_run']['fused_chunk'],
            'tail0_steps': main_tracks['steps'],
            'tracks_s': records['tracks']['seconds'],
            'tail0_tracks_s': main_tracks['seconds']}
    say(f'auto tail: round trip {rtt * 1e6:.1f} us, per slot '
        f'{(per_slot or 0) * 1e12:.1f} ps, compactions to {buckets} '
        f'(stopped at {auto["stopped_at"]}); {steps} steps in '
        f'{launched["auto_run"]["fused_chunk"]} chunk launches, '
        f'{records["tracks"]["seconds"]:.3f} s, against tail 0: '
        f'{main_tracks["steps"]} steps, {main_tracks["seconds"]:.3f} s; '
        'counts = mass' + (', = the main run\'s' if same else '') +
        f' on {device_name}')
    total = {k: sum(run[k] for run in launched.values())
             for k in launched['auto_run']}
    return total, {'batched_sweep': batched, 'hard_batch': hard, 'mg': mg,
                   'auto_tail': auto}


def phase_thermals_run(torch, device_name, out):
    """Two thermal realizations at the README region's width, 100,000
    tracks each, counts only: three work items through the batched driver,
    once with device-resident fields and once through numpy (bitwise-equal
    artifacts); the presence map sums the three realizations."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents import smooth_presence
    runs = {}
    for fields_device in (True, False):
        cfg = Config(out_dir=out, **{
            **MAIN_CONFIG, 'run_name': f'wy_thermals_{fields_device}',
            'thermals_realization_count': 2, 'track_pkl_budget': 0,
            'fields_device': fields_device})
        t0 = time.perf_counter()
        sim = Simulator(cfg)
        ctor = time.perf_counter() - t0
        _reset_counts()
        sim.simulate_tracks()
        launched = _read_counts()
        recs = [r for r in sim.timer.records
                if r['phase'] == 'batched_tracks']
        pots = [r for r in sim.timer.records if r['phase'] == 'potential']
        if len(recs) != 1 or recs[0]['cases'] != 3 or len(pots) != 3:
            fail(f'thermals run: batched records {recs}, {len(pots)} '
                 'potential records')
        _check_batched_launches('thermals run', launched, recs[0])
        case = sim.case_ids[0]
        arts = {}
        for real in range(3):
            ident = sim._get_id_string(case, real)
            for kind in ('counts', 'potential'):
                arts[f'{ident}_{kind}'] = np.load(os.path.join(
                    sim.mode_data_dir, f'{ident}_{kind}.npy'))
            _check_case_counts(f'thermals run r{real}',
                               arts[f'{ident}_counts'], cfg.track_count,
                               sim.grid.burnin_length())
        for real in range(2):
            arts[f'thermals_{real}'] = np.load(os.path.join(
                sim.mode_data_dir, f'{case}_r{real}_thermals.npy'))
        runs[fields_device] = (sim, arts, launched, recs[0], pots, ctor)
    sim, arts, launched, rec, pots, ctor = runs[True]
    host = runs[False][1]
    if arts.keys() != host.keys() or any(
            not np.array_equal(arts[k], host[k]) for k in arts):
        fail('thermals run: fields_device on and off give different '
             'artifacts')
    if not arts['thermals_0'].max() > 0. or \
            np.array_equal(arts['thermals_0'], arts['thermals_1']):
        fail('thermals run: the thermal fields are empty or equal')
    summary = sim.compute_presence_map()
    krad = sim._presence_kernel_radius(1000.)
    case_prob = np.zeros((NROW, NCOL))
    for real in range(3):
        ident = sim._get_id_string(sim.case_ids[0], real)
        prob = smooth_presence(torch.from_numpy(
            arts[f'{ident}_counts']).to(sim.device), krad).cpu().numpy()
        case_prob += prob / prob.max()
    case_prob /= case_prob.max()
    if summary.max() != 1.0 or \
            np.abs(summary - case_prob / case_prob.max()).max() > 1e-6:
        fail('thermals run: the presence map is not the sum over the three '
             'realizations')
    phases = {r['phase']: r['seconds'] for r in sim.timer.records
              if r['phase'] in ('terrain', 'updrafts', 'thermals',
                                'simulate_tracks', 'presence_map')}
    prep_s = sum(r['seconds'] for r in pots)
    say('thermals run potentials: ' + '; '.join(
        f'r{i} ' + _solver_line(r).split(' ', 1)[1]
        for i, r in enumerate(pots)))
    say(f'thermals run: 3 realizations x {sim.track_count} tracks; ctor '
        f'{ctor:.3f} s (thermal fields {phases["thermals"]:.3f} s), '
        f'potentials {prep_s:.3f} s, batched track phase '
        f'{rec["seconds"]:.3f} s for {rec["useful_steps"]} agent-steps = '
        f'{rec["useful_steps"] / rec["seconds"]:.4g} agent-steps/s, '
        f'presence_map {phases["presence_map"]:.3f} s; steps '
        f'{rec["steps"]}, {launched["fused_chunk"]} chunk launches, '
        f'{launched["flushes"]} flushes; fields_device on and off: '
        f'bitwise-equal counts, potentials and thermal fields (host flow: '
        f'potentials {sum(r["seconds"] for r in runs[False][4]):.3f} s, '
        f'batched track phase {runs[False][3]["seconds"]:.3f} s); the '
        f'presence map sums the three realizations, on {device_name}')
    return launched, {
        'ctor_s': ctor, 'thermals_s': phases['thermals'],
        'potentials_s': prep_s, 'batched_tracks_s': rec['seconds'],
        'useful_steps': rec['useful_steps'], 'steps': rec['steps'],
        'presence_map_s': phases['presence_map'],
        'potentials': [{k: r[k] for k in ('id', 'solver', 'fallback', 'rrel',
                                          'seconds', 'vcycles')}
                       for r in pots],
        'host_flow': {'potentials_s': sum(r['seconds']
                                          for r in runs[False][4]),
                      'batched_tracks_s': runs[False][3]['seconds']}}


def phase_drw(torch, device_name, out):
    """The directed random walk at the README region's width, 100,000
    tracks: no potential phase and no potential artifact, the chunk kernel
    without a table; a second run in the same directory equal to the
    first; then the per-step driver without a table."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents.simulate import simulate_presence
    cfg = Config(out_dir=out, **{**MAIN_CONFIG, 'run_name': 'wy_drw',
                                 'movement_model': 'drw'})
    results = []
    for _ in range(2):
        sim = Simulator(cfg)
        _reset_counts()
        sim.simulate_tracks()
        launched = _read_counts()
        records = {r['phase']: r for r in sim.timer.records}
        rec = records['tracks']
        if 'potential' in records or 'batched_tracks' in records or \
                [n for n in os.listdir(sim.mode_data_dir)
                 if 'potential' in n]:
            fail('drw run: a potential phase or artifact')
        _check_chunk_launches('drw run', launched, rec['steps'])
        _check_flush_launches('drw run', launched)
        ident = sim._get_id_string(sim.case_ids[0], 0)
        if '_drw_' not in ident:
            fail(f'drw run: artifact id {ident}')
        counts = np.load(os.path.join(sim.mode_data_dir,
                                      f'{ident}_counts.npy'))
        _check_case_counts('drw run', counts, cfg.track_count,
                           sim.grid.burnin_length())
        results.append((counts, rec, launched))
    (counts, rec, launched), (again, warm, _) = results
    if not np.array_equal(counts, again) or rec['steps'] != warm['steps']:
        fail('drw run: the second run differs from the first')
    sim.compute_presence_map()
    say(f'drw run: {cfg.track_count} tracks, {rec["steps"]} steps, '
        f'{launched["fused_chunk"]} chunk launches without a table, '
        f'{launched["flushes"]} flushes, no potential; '
        f'{rec["useful_steps"]} agent-steps in {rec["seconds"]:.3f} s = '
        f'{rec["useful_steps"] / rec["seconds"]:.4g} agent-steps/s; second '
        f'run {warm["seconds"]:.3f} s, equal counts, on {device_name}')
    # the per-step kernel's path without a table
    params = sim._track_params()
    starts = _run_starts(cfg)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    presence, ps_steps = simulate_presence(
        params, starts, torch.Generator(device=sim.device).manual_seed(2034))
    torch.cuda.synchronize()
    ps_s = time.perf_counter() - t0
    per_step = _read_counts()
    mass = int(presence.sum())
    _check_flush_launches('drw per-step driver', per_step, flushes=1)
    if per_step['fused_step'] != ps_steps or per_step['fused_chunk'] or \
            mass < cfg.track_count * (params.burnin + 1):
        fail(f'drw per-step driver: {per_step} for {ps_steps} steps, mass '
             f'{mass}')
    say(f'drw per-step driver (simulate_presence without a table): '
        f'{ps_steps} steps through {per_step["fused_step"]} fused step '
        f'launches, {mass - cfg.track_count} agent-steps in {ps_s:.3f} s')
    return launched, {
        'steps': rec['steps'], 'tracks_s': rec['seconds'],
        'useful_steps': rec['useful_steps'], 'second_run_s': warm['seconds'],
        'per_step_driver': {'steps': ps_steps, 'seconds': ps_s,
                            'fused_step_launches': per_step['fused_step']}}


def _refuse_http():
    """Register a ``requests`` of the script's own that refuses every
    request, so that the runs are offline whether or not the machine has
    the package or a network: the terrain chain (3DEP -> SRTM ->
    synthetic) ends at the synthetic DEM, and the USWTDB fetch at None.
    Returns the module, which the last check looks for."""
    import types

    class ConnectionError(OSError):
        pass

    def get(*args, **kwargs):
        raise ConnectionError('chip_smoke.py runs offline')

    mod = types.ModuleType('requests')
    mod.get = get
    mod.exceptions = types.SimpleNamespace(
        ConnectionError=ConnectionError, ConnectTimeout=ConnectionError,
        HTTPError=ConnectionError)
    sys.modules['requests'] = mod
    return mod


def _region_lonlat_bounds(cfg=None):
    """(west, south, east, north) in lon/lat of the region of ``cfg`` (a
    ``Config``; the README region without one), as the ``Simulator``
    works them out."""
    from ssrs_tpu_torch import Config
    from ssrs_tpu_torch.core.grid import Grid
    from ssrs_tpu_torch.data import transform_bounds, transform_coordinates
    cfg = Config(**MAIN_CONFIG) if cfg is None else cfg
    west, south = transform_coordinates(
        'EPSG:4326', cfg.projected_crs, cfg.southwest_lonlat[0],
        cfg.southwest_lonlat[1])
    grid = Grid.from_region(tuple(cfg.region_width_km), cfg.resolution,
                            (float(np.asarray(west).ravel()[0]),
                             float(np.asarray(south).ravel()[0])))
    return transform_bounds(grid.bounds, cfg.projected_crs, 'EPSG:4326')


def _wtk_sites(lonlat_bounds=None):
    """(lat, lon) of the stand-in's sites, lat-major: a 2-km lattice over
    the lon/lat bounds (the README region's without them) and a margin,
    each site moved off the lattice by up to 200 m (WTK's projected grid
    is not a lattice in lon/lat either, and four sites on a circle have two
    triangulations)."""
    lon0, lat0, lon1, lat1 = _region_lonlat_bounds() \
        if lonlat_bounds is None else lonlat_bounds
    mid = math.radians((lat0 + lat1) / 2)
    dlat = WTK_SPACING_KM / 111.2
    dlon = dlat / math.cos(mid)
    lats = np.arange(lat0 - WTK_MARGIN_DEG, lat1 + WTK_MARGIN_DEG, dlat)
    lons = np.arange(lon0 - WTK_MARGIN_DEG, lon1 + WTK_MARGIN_DEG, dlon)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    rng = np.random.default_rng(MAIN_CONFIG['sim_seed'])
    lat_g = lat_g + rng.uniform(-0.1, 0.1, lat_g.shape) * dlat
    lon_g = lon_g + rng.uniform(-0.1, 0.1, lon_g.shape) * dlon
    return lat_g.ravel(), lon_g.ravel()


def _wtk_raw(name, hours, lat, lon):
    """The stand-in's int32 values of one layer at ``hours`` (hours since
    Jan 1, any shape that broadcasts against the sites): speeds of 4-14
    m/s, a direction that turns by ~110 degrees over the region and by 7
    degrees an hour, divided into ``WTK_SCALE[name]`` as the archive's
    ``scale_factor`` has it."""
    h = np.asarray(hours, np.float64)
    x, y = (lon + 106.) / 0.8, (lat - 42.8) / 0.5
    if name.startswith('windspeed'):
        val = 9. + 5. * np.sin(0.37 * h + 2.1 * x + 1.3 * y)
    elif name.startswith('winddirection'):
        val = np.mod(235. + 7. * h + 70. * x + 40. * y, 360.)
    elif name.startswith('pressure'):
        val = 85000. + 400. * np.sin(0.05 * h) - 900. * y
    elif name.startswith('temperature'):
        val = 12. + 9. * np.sin(2 * math.pi * (h % 24 - 9) / 24) - 2. * y
    elif name == 'boundary_layer_height':
        val = 900. + 600. * np.sin(2 * math.pi * (h % 24 - 8) / 24) ** 2 \
            + 0. * x
    else:
        val = 150. + 120. * np.sin(2 * math.pi * (h % 24 - 7) / 24) + 0. * x
    return np.round(val * WTK_SCALE[name]).astype(np.int32)


class _StandInDataset:
    """An h5py-shaped dataset whose values are a function of the index:
    numpy indexing of ``(hours, sites)``, ``attrs``."""

    def __init__(self, name, lat, lon, hours):
        self._name, self._lat, self._lon = name, lat, lon
        self._hours = hours
        self.attrs = {} if name == 'coordinates' else \
            {'scale_factor': WTK_SCALE[name]}
        self.shape = (len(lat), 2) if name == 'coordinates' else \
            (hours, len(lat))

    def __getitem__(self, key):
        if self._name == 'coordinates':
            return np.stack([self._lat, self._lon], axis=1)[key]
        hours, sites = key
        hours = np.arange(self._hours)[hours]
        return _wtk_raw(self._name, hours[..., None] if np.ndim(hours)
                        else hours, self._lat[sites], self._lon[sites])


class _StandInH5:
    """An ``h5py``-shaped module over the stand-in: ``File(path, mode)`` as
    a context manager with ``__iter__`` and ``__getitem__``, for the paths
    ``add`` was given. ``reads`` lists every dataset taken from a file."""

    def __init__(self):
        self.reads = reads = []
        self.files = files = {}

        class File:
            def __init__(self, path, mode='r', **kwargs):
                if os.path.abspath(path) not in files:
                    raise FileNotFoundError(path)
                lat, lon, hours = files[os.path.abspath(path)]
                self._sets = {n: _StandInDataset(n, lat, lon, hours)
                              for n in ['coordinates'] + WTK_LAYERS}

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def __iter__(self):
                return iter(self._sets)

            def __getitem__(self, name):
                reads.append(name)
                return self._sets[name]

        self.File = File

    def add(self, fpath, lat, lon, hours):
        """The stand-in at ``fpath``: these sites, ``hours`` hours."""
        with open(fpath, 'wb') as fobj:
            fobj.write(b'stand-in; the values are computed by chip_smoke.py')
        self.files[os.path.abspath(fpath)] = (lat, lon, hours)


def _year_hours(year):
    return 24 * (366 if year % 4 == 0 else 365)


def _write_h5(h5py, fpath, lat, lon, hours):
    """The stand-in as a real ``.h5`` file, two months at a time."""
    with h5py.File(fpath, 'w') as fobj:
        fobj.create_dataset('coordinates', data=np.stack([lat, lon], axis=1))
        for name in WTK_LAYERS:
            dset = fobj.create_dataset(name, (hours, len(lat)), 'i4')
            dset.attrs['scale_factor'] = WTK_SCALE[name]
            for h0 in range(0, hours, 24 * 61):
                span = np.arange(h0, min(h0 + 24 * 61, hours))
                dset[span[0]:span[-1] + 1] = _wtk_raw(name, span[:, None],
                                                      lat, lon)


def _add_standin(fpath, lat, lon, year):
    """One more year or region of the stand-in, after
    ``phase_wtk_archive``: a real ``.h5`` where ``h5py`` imports, else a
    path of the script's own ``h5py``-shaped module."""
    mod = sys.modules['h5py']
    if isinstance(mod, _StandInH5):
        mod.add(fpath, lat, lon, _year_hours(year))
    else:
        _write_h5(mod, fpath, lat, lon, _year_hours(year))


def phase_wtk_archive(out):
    """The WTK stand-in for 2012 (an hourly 2-km grid of six layers): a
    real ``.h5`` for the ``LOCAL`` source where ``h5py`` imports, else an
    ``h5py``-shaped module of the script's own in ``sys.modules``. Returns
    the ``wtk_local_template`` and a function that says how many times a
    dataset was taken from the source's files since its last call."""
    import types
    lat, lon = _wtk_sites()
    fpath = os.path.join(out, f'wtk_standin_{WTK_YEAR}.h5')
    t0 = time.perf_counter()
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is not None:
        _write_h5(h5py, fpath, lat, lon, WTK_HOURS)
        # count the datasets taken, through a module that hands h5py's
        # files on
        reads = []
        real_file = h5py.File

        class CountingFile(real_file):
            def __getitem__(self, name):
                reads.append(name)
                return super().__getitem__(name)

        counting = types.ModuleType('h5py')
        counting.__dict__.update(h5py.__dict__)
        counting.File = CountingFile
        sys.modules['h5py'] = counting
        kind = f'a real .h5 through h5py {h5py.__version__} ' \
            f'({os.path.getsize(fpath) / 1e6:.0f} MB)'
    else:
        standin = _StandInH5()
        standin.add(fpath, lat, lon, WTK_HOURS)
        reads = standin.reads
        sys.modules['h5py'] = standin
        kind = "an h5py-shaped module of the script's own (no h5py here)"

    def reads_since_last():
        n = len(reads)
        del reads[:]
        return n

    say(f'WTK stand-in: {kind}; {len(lat)} sites on a '
        f'{WTK_SPACING_KM:g}-km grid, {WTK_HOURS} hours of {WTK_YEAR}, '
        f'{len(WTK_LAYERS)} layers, {time.perf_counter() - t0:.2f} s')
    return fpath.replace(str(WTK_YEAR), '$YEAR'), reads_since_last


def _wtk_config(template, **kw):
    return {**MAIN_CONFIG, 'wtk_source': 'LOCAL',
            'wtk_local_template': template, 'wtk_local_years': (WTK_YEAR,),
            **kw}


def _phase_seconds(records, name):
    return [r['seconds'] for r in records if r['phase'] == name]


def _wtk_phase_line(label, records):
    """One line of the constructor's phases of a WTK run."""
    frames = _phase_seconds(records, 'wtk_frame')
    interp = _phase_seconds(records, 'wtk_interp')
    one = {k: _phase_seconds(records, k)[0]
           for k in ('terrain', 'turbines', 'wtk_download', 'updrafts',
                     'thermals')}
    say(f'{label} ctor phases (s): terrain {one["terrain"]:.3f}, turbines '
        f'{one["turbines"]:.4f}, WTK reads of {len(frames)} timestamps '
        f'{one["wtk_download"]:.3f} (and {sum(frames):.3f} reading the '
        f'cached frames back), interpolation {sum(interp):.3f} '
        f'({len(interp)} cases, {min(interp):.3f}-{max(interp):.3f} '
        f'each), updrafts {one["updrafts"]:.3f} in all, thermals '
        f'{one["thermals"]:.3f}')
    return {**one, 'wtk_frames': sum(frames), 'wtk_interp': sum(interp)}


def _csv_mtimes(dirname):
    return {n: os.stat(os.path.join(dirname, n)).st_mtime_ns
            for n in sorted(os.listdir(dirname)) if n.endswith('.csv')}


def phase_seasonal(torch, device_name, out, template, wtk_reads):
    """Seasonal mode at the README region's width: SEASONAL_COUNT
    timestamps of the WTK stand-in (the default ``seasonal_count``),
    100,000 tracks a case, counts only, through the multi-case driver."""
    import shutil
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents import get_starting_indices
    from ssrs_tpu_torch.utils import get_seasonal_datetimes_list
    cfg = Config(out_dir=out, **_wtk_config(
        template, run_name='wy_seasonal', sim_mode='seasonal',
        seasonal_count=SEASONAL_COUNT, track_pkl_budget=0))
    wtk_reads()
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    ctor = time.perf_counter() - t0
    n_reads = wtk_reads()
    n_cases = SEASONAL_COUNT
    tracks = cfg.track_count
    # the cases and the starts of the seed: the sampler draws from the
    # run's generator first, the starts after it
    rng = np.random.default_rng(cfg.sim_seed)
    want = get_seasonal_datetimes_list(
        [WTK_YEAR], cfg.seasonal_start, cfg.seasonal_end,
        cfg.seasonal_timeofday, n_cases, tuple(sim.lonlat_bounds[0:2]), rng)
    rows, cols = get_starting_indices(
        tracks, list(cfg.track_start_region), cfg.track_start_type,
        tuple(cfg.region_width_km), float(cfg.resolution), rng=rng)
    starts = np.stack([rows, cols], axis=1).astype(np.int32)
    cases = [dt.strftime(sim.time_format) for dt in want]
    if sim.case_ids != cases or len(set(cases)) != n_cases:
        fail(f'seasonal run: case ids {sim.case_ids}, not {cases}')
    # the coordinates twice, then every layer of every timestamp for its
    # scale factor and for its values
    if n_reads != 2 + 2 * n_cases * len(WTK_LAYERS):
        fail(f'seasonal run: {n_reads} dataset reads of the WTK source')
    ctor_s = _wtk_phase_line('seasonal run', sim.timer.records)
    if sim.turbines.dframe is not None or \
            sim.terrain_layers != {'Elevation': 'SYNTHETIC'}:
        fail('seasonal run: the run was not offline')
    n_sites = len(sim.wtk.get_locations())
    _reset_counts()
    sim.simulate_tracks()
    launched = _read_counts()
    pots = [r for r in sim.timer.records if r['phase'] == 'potential']
    recs = [r for r in sim.timer.records if r['phase'] == 'batched_tracks']
    if len(pots) != n_cases or len(recs) != 1 or \
            recs[0]['cases'] != n_cases or \
            any(r['solver'] not in ('refined', 'direct') for r in pots):
        fail(f'seasonal run: {len(pots)} potential records, batched '
             f'records {recs}')
    rec = recs[0]
    _check_batched_launches('seasonal run', launched, rec)
    burnin = sim.grid.burnin_length()

    def load(simulator, case, kind):
        return np.load(os.path.join(
            simulator.mode_data_dir,
            f'{simulator._get_id_string(case, 0)}_{kind}.npy'))

    counts = [load(sim, c, 'counts') for c in cases]
    mass = sum(_check_case_counts(f'seasonal run {c}', counts[i], tracks,
                                  burnin) for i, c in enumerate(cases))
    if rec['useful_steps'] != mass - n_cases * tracks:
        fail(f'seasonal run: useful_steps {rec["useful_steps"]} != '
             f'{mass - n_cases * tracks}')
    prep_s = sum(r['seconds'] for r in pots)
    n_fallback = sum(bool(r['fallback']) for r in pots)
    say('seasonal run potentials: ' + '; '.join(
        _solver_line(r) + f' {r["vcycles"]} V-cycles' for r in pots))
    say(f'seasonal run: {n_cases} cases x {tracks} tracks, {n_sites} WTK '
        f'sites; ctor {ctor:.3f} s, potentials {prep_s:.3f} s '
        f'({n_fallback} fallbacks), batched track phase '
        f'{rec["seconds"]:.3f} s for {rec["useful_steps"]} agent-steps = '
        f'{rec["useful_steps"] / rec["seconds"]:.4g} agent-steps/s; steps '
        f'{rec["steps"]}, {launched["fused_chunk"]} chunk launches, '
        f'{launched["flushes"]} flushes through '
        f'{launched["presence_flush"]} flush launches, 0 per-step launches '
        f'on {device_name}')
    fallen = [i for i, r in enumerate(pots) if r['fallback'] and i > 0]
    _check_cases_against_single(
        torch, sim, 'seasonal run', starts, rec, counts,
        [0, (fallen + [n_cases // 2 + 1])[0]])

    # one case's orograph on the CPU: a snapshot run of that timestamp
    # from a copy of the cached WTK frame, device='cpu'
    pick = n_cases // 2
    cpu_cfg = Config(out_dir=out, **_wtk_config(
        template, run_name='wy_seasonal_cpu', sim_mode='snapshot',
        snapshot_datetime=(want[pick].year, want[pick].month,
                           want[pick].day, want[pick].hour),
        track_pkl_budget=0))
    cpu_dir = os.path.join(out, cpu_cfg.run_name, 'data', 'snapshot')
    os.makedirs(cpu_dir)
    for name in ('wtk_locations.csv', 'wtk_locations_bounds.json',
                 f'{cases[pick]}_wtk.csv'):
        shutil.copy(os.path.join(sim.mode_data_dir, name), cpu_dir)
    wtk_reads()
    cpu_sim = Simulator(cpu_cfg, device='cpu')
    if wtk_reads() or cpu_sim.case_ids != [cases[pick]]:
        fail('seasonal run: the CPU run did not take the cached WTK frame')
    oro = np.load(os.path.join(sim.mode_data_dir,
                               f'{cases[pick]}_orograph.npy'))
    oro_cpu = np.load(os.path.join(cpu_dir, f'{cases[pick]}_orograph.npy'))
    oro_err = float(np.abs(oro - oro_cpu).max())
    if oro.shape != (NROW, NCOL) or not np.allclose(
            oro, oro_cpu, rtol=ORO_RTOL, atol=ORO_ATOL) or \
            not oro.max() > cfg.updraft_threshold:
        fail(f'seasonal run: the orograph of {cases[pick]} on the card '
             f'differs from the CPU\'s by {oro_err:.3g}')
    say(f'seasonal run: orograph of {cases[pick]} on the card against '
        f'device=\'cpu\' on the same cached frame: max |diff| {oro_err:.3g} '
        f'of max {oro.max():.3f} m/s (rtol {ORO_RTOL:g}, atol {ORO_ATOL:g})')

    # a second Simulator on the same directory: the source is opened for
    # the layer probe and no dataset is read, the CSV caches stay as they
    # are, every potential comes from the cache, the counts are equal
    mtimes = _csv_mtimes(sim.mode_data_dir)
    if len(mtimes) != 1 + n_cases:
        fail(f'seasonal run: CSV caches {sorted(mtimes)}')
    wtk_reads()
    t0 = time.perf_counter()
    again = Simulator(cfg)
    rerun_ctor = time.perf_counter() - t0
    n_reads = wtk_reads()
    again.simulate_tracks()
    rerun_s = time.perf_counter() - t0
    hits = sum(r['solver'] == 'cache' for r in again.timer.records
               if r['phase'] == 'potential')
    if n_reads or _csv_mtimes(sim.mode_data_dir) != mtimes or \
            again.case_ids != cases or hits != n_cases or any(
                not np.array_equal(load(again, c, 'counts'), counts[i])
                for i, c in enumerate(cases)):
        fail(f'seasonal rerun: {n_reads} dataset reads, {hits} potential '
             f'cache hits of {n_cases}, or the caches or counts changed')
    say(f'seasonal rerun: 0 dataset reads of the WTK source, the '
        f'{len(mtimes)} CSV caches untouched, {hits} potential cache hits, '
        f'equal counts; ctor {rerun_ctor:.3f} s, with the tracks '
        f'{rerun_s:.3f} s')
    summary = sim.compute_presence_map()
    if summary.shape != (NROW, NCOL) or summary.max() != 1.0:
        fail('seasonal run: the presence map is not max-normalized')
    return launched, {
        'cases': cases, 'wtk_sites': n_sites, 'ctor_s': ctor,
        'ctor_phases_s': ctor_s, 'potentials_s': prep_s,
        'potentials': [{k: r[k] for k in ('id', 'solver', 'fallback', 'rrel',
                                          'seconds', 'vcycles')}
                       for r in pots],
        'batched_tracks_s': rec['seconds'],
        'useful_steps': rec['useful_steps'], 'steps': rec['steps'],
        'chunk_launches': launched['fused_chunk'],
        'flushes': launched['flushes'], 'orograph_card_vs_cpu': oro_err,
        'rerun_ctor_s': rerun_ctor, 'rerun_s': rerun_s}


def _turbine_fixture(cfg=None):
    """A few dozen USWTDB-shaped turbines in and around the region of
    ``cfg`` (the README region without one; its lon/lat box widened by a
    third on every side), hub heights on both sides of
    ``turbine_minimum_hubheight``."""
    rng = np.random.default_rng(MAIN_CONFIG['sim_seed'])
    n = SNAPSHOT_TURBINES
    lon0, lat0, lon1, lat1 = _region_lonlat_bounds(cfg)
    dlon, dlat = (lon1 - lon0) / 3, (lat1 - lat0) / 3
    hub = rng.uniform(25., 120., n).round(1)
    return {
        't_state': ['WY'] * n,
        'p_name': [f'Project {i % 5}' for i in range(n)],
        'p_year': [2005 + i % 15 for i in range(n)],
        't_cap': [1500 + 100 * (i % 10) for i in range(n)],
        't_hh': hub, 't_rd': (hub * 1.1).round(1),
        'xlong': rng.uniform(lon0 - dlon, lon1 + dlon, n),
        'ylat': rng.uniform(lat0 - dlat, lat1 + dlat, n)}


def phase_snapshot(torch, device_name, out, template):
    """Snapshot mode with turbines at the README region's width: one
    timestamp of the WTK stand-in, one thermal realization, 10,000 recorded
    tracks (``_tracks.pkl``), and the presence scores of a fixture of
    turbines passed in as the simulator module's ``TurbinesUSWTB``."""
    import ssrs_tpu_torch.simulator as sim_mod
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.data import read_csv, transform_coordinates
    fixture = _turbine_fixture()
    real_tb = sim_mod.TurbinesUSWTB

    class FixtureTB(real_tb):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dataframe=dict(fixture), **kwargs)

    cfg = Config(out_dir=out, **_wtk_config(
        template, run_name='wy_snapshot', sim_mode='snapshot',
        snapshot_datetime=SNAPSHOT_DATETIME, track_count=RECORDED_TRACKS,
        thermals_realization_count=1))
    sim_mod.TurbinesUSWTB = FixtureTB
    try:
        t0 = time.perf_counter()
        sim = Simulator(cfg)
        ctor = time.perf_counter() - t0
    finally:
        sim_mod.TurbinesUSWTB = real_tb
    case = '{:04d}m{:02d}d{:02d}h{:02d}'.format(*SNAPSHOT_DATETIME)
    if sim.case_ids != ['y' + case]:
        fail(f'snapshot run: case ids {sim.case_ids}')
    case = sim.case_ids[0]
    ctor_s = _wtk_phase_line('snapshot run', sim.timer.records)

    # turbines.csv: exactly the turbines inside the bounds and at or above
    # the hub height, by their row numbers in the fixture
    xs, ys = transform_coordinates('EPSG:4326', cfg.projected_crs,
                                   fixture['xlong'], fixture['ylat'])
    b = sim.bounds
    keep = np.nonzero((xs >= b[0]) & (xs <= b[2]) & (ys >= b[1])
                      & (ys <= b[3]) & (fixture['t_hh']
                                        >= cfg.turbine_minimum_hubheight))[0]
    saved = read_csv(os.path.join(sim.mode_data_dir, 'turbines.csv'))
    inside = np.count_nonzero((xs >= b[0]) & (xs <= b[2]) & (ys >= b[1])
                              & (ys <= b[3]))
    if not np.array_equal(saved.index, keep) or not (
            0 < len(keep) < inside < SNAPSHOT_TURBINES) or \
            not saved.equals(sim.turbines.dframe) or \
            not np.array_equal(saved['t_hh'], fixture['t_hh'][keep]):
        fail(f'snapshot run: turbines.csv holds rows {list(saved.index)}, '
             f'not {list(keep)}')

    _reset_counts()
    sim.simulate_tracks()
    launched = _read_counts()
    tracks_recs = [r for r in sim.timer.records if r['phase'] == 'tracks']
    pots = [r for r in sim.timer.records if r['phase'] == 'potential']
    if len(tracks_recs) != 2 or len(pots) != 2 or \
            not all(r.get('recorded') and r['builder'] == 'native'
                    for r in tracks_recs):
        fail(f'snapshot run: tracks records {tracks_recs}')
    _check_chunk_launches('snapshot run', launched,
                          [r['steps'] for r in tracks_recs])
    _check_flush_launches('snapshot run', launched)

    # the recorded counts against the recount of the .pkl: with the
    # _counts.npy moved away the presence map recounts through kernel C,
    # one launch a realization
    paths = [os.path.join(sim.mode_data_dir,
                          f'{sim._get_id_string(case, r)}_counts.npy')
             for r in (0, 1)]
    counts = [np.load(f) for f in paths]
    for real in (0, 1):
        with open(paths[real].replace('_counts.npy', '_tracks.pkl'),
                  'rb') as fobj:
            lengths = sum(len(t) for t in pickle.load(fobj))
        if int(counts[real].sum(dtype=np.int64)) != lengths:
            fail(f'snapshot run r{real}: counts mass != sum of lengths')
    for f in paths:
        os.replace(f, f + '.moved')
    _reset_counts()
    recounts = [sim.get_presence_counts(case, r) for r in (0, 1)]
    scores = sim.get_turbine_presence()
    recounted = _read_counts()
    for f in paths:
        os.replace(f + '.moved', f)
    # two recounts asked for here, two more by the presence map
    if recounted['presence_histogram_batch'] != 4 or \
            recounted['fused_chunk'] or recounted['fused_step'] or \
            recounted['presence_flush'] or recounted['presence_histogram']:
        fail(f'snapshot run: four recounts launched {recounted}')
    if any(not np.array_equal(r, c.astype(np.int16))
           for r, c in zip(recounts, counts)):
        fail('snapshot run: _counts.npy differs from the recount of the pkl')
    launched['presence_histogram_batch'] = \
        recounted['presence_histogram_batch']
    summary = np.load(os.path.join(sim.mode_data_dir,
                                   'summary_presence.npy'))
    from_counts = sim.compute_presence_map()
    if np.abs(from_counts - summary).max() > 1e-6 or summary.max() != 1.0:
        fail('snapshot run: the presence map of the recounts differs from '
             'that of the counts')

    # the scores: one a turbine, in [0, 1], sorted, each the summary map at
    # the cell searchsorted gives
    pres = scores['presence']
    xgrid, ygrid = sim.get_terrain_grid()
    at = summary[np.clip(np.searchsorted(ygrid, scores['y']), 0, NROW - 1),
                 np.clip(np.searchsorted(xgrid, scores['x']), 0, NCOL - 1)]
    if len(scores) != len(keep) or sorted(scores.index) != list(keep) or \
            pres.min() < 0. or pres.max() > 1. or \
            (np.diff(pres) > 0).any() or \
            np.abs(pres - at).max() > 1e-6 or \
            'presence' in sim.turbines.dframe:
        fail(f'snapshot run: turbine scores {pres}')
    say('snapshot run potentials: ' + '; '.join(
        f'r{i} ' + _solver_line(r).split(' ', 1)[1]
        + f' {r["vcycles"]} V-cycles' for i, r in enumerate(pots)))
    say(f'snapshot run: {case}, {cfg.track_count} recorded tracks x 2 '
        f'realizations; ctor {ctor:.3f} s; steps '
        f'{[r["steps"] for r in tracks_recs]}, {launched["fused_chunk"]} '
        f'chunk launches, {launched["flushes"]} flushes through '
        f'{launched["presence_flush"]} flush launches; tracks '
        f'{sum(r["seconds"] for r in tracks_recs):.3f} s for '
        f'{sum(r["useful_steps"] for r in tracks_recs)} agent-steps; '
        f'counts = the .pkl recounts, one launch of the count kernel each; '
        f'turbines: {SNAPSHOT_TURBINES} in the fixture, {inside} inside '
        f'the bounds, {len(keep)} of them at or above '
        f'{cfg.turbine_minimum_hubheight:g} m in turbines.csv; scores '
        f'{pres.max():.4f}..{pres.min():.4f}, sorted, each equal to '
        f'summary_presence.npy at its cell, on {device_name}')
    return launched, {
        'case': case, 'ctor_s': ctor, 'ctor_phases_s': ctor_s,
        'potentials': [{k: r[k] for k in ('id', 'solver', 'fallback', 'rrel',
                                          'seconds', 'vcycles')}
                       for r in pots],
        'tracks_s': [r['seconds'] for r in tracks_recs],
        'steps': [r['steps'] for r in tracks_recs],
        'useful_steps': [r['useful_steps'] for r in tracks_recs],
        'turbines': {'fixture': SNAPSHOT_TURBINES, 'inside': int(inside),
                     'scored': int(len(keep)),
                     'presence_max': float(pres.max()),
                     'presence_min': float(pres.min())}}


def _saved_run(sim):
    """The run JSON that ``sim``'s constructor wrote, as bytes, and its run's
    counts and summary."""
    with open(os.path.join(sim.out_dir, sim.run_name,
                           f'{sim.run_name}.json'), 'rb') as fobj:
        text = fobj.read()
    ident = sim._get_id_string(sim.case_ids[0], 0)
    return {'json': text,
            'counts': np.load(os.path.join(sim.mode_data_dir,
                                           f'{ident}_counts.npy')),
            'summary': np.load(os.path.join(sim.mode_data_dir,
                                            'summary_presence.npy'))}


def _cli_run(label, path, plots=False):
    """``python -m ssrs_tpu_torch run path [--no-plots]``, called in this
    process so that the script's refusing ``requests`` keeps it offline.
    Checks the launches (one chunk launch a chunk, one flush launch a
    flush); returns them, the run's phase records by name, its directory
    and its wall seconds."""
    from ssrs_tpu_torch.__main__ import main as cli_main
    with open(path) as fobj:
        cfg = json.load(fobj)
    run_dir = os.path.join(cfg['out_dir'], cfg['run_name'])
    _reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(['run', path] + ([] if plots else ['--no-plots']))
    wall = time.perf_counter() - t0
    launched = _read_counts()
    if rc != 0:
        fail(f'{label}: exit code {rc}')
    with open(os.path.join(run_dir, 'phase_timings.json')) as fobj:
        records = {r['phase']: r for r in json.load(fobj)}
    _check_chunk_launches(label, launched, records['tracks']['steps'])
    _check_flush_launches(label, launched)
    return launched, records, run_dir, wall


def phase_cli(torch, device_name, out, main_saved):
    """``python -m ssrs_tpu_torch``: ``info`` in a subprocess, then, in this
    process, the main run again from the JSON its ``Simulator`` wrote (with
    the four keys that ``ssrs_tpu``'s own CLI refuses), the reference's
    three example regions at their published size (uniform, 1,000
    recorded tracks each), one region's presence map again from its
    ``.pkl``, and the figures' need for matplotlib."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.__main__ import DERIVED_KEYS
    from ssrs_tpu_torch.__main__ import main as cli_main
    from ssrs_tpu_torch.agents.presence import track_points
    from ssrs_tpu_torch.agents.presence_hist import (
        presence_histogram_batch, presence_histogram_batch_plain)
    info = subprocess.run([sys.executable, '-m', 'ssrs_tpu_torch', 'info'],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    if info.returncode != 0 or device_name not in info.stdout:
        fail(f'cli info: exit {info.returncode}, output {info.stdout!r}, '
             f'errors {info.stderr[-2000:]!r}')
    say('cli info: ' + '; '.join(info.stdout.strip().splitlines()))
    total = dict.fromkeys(_read_counts(), 0)

    def add(launched):
        for key, n in launched.items():
            total[key] += n

    # the main run again, from the JSON its Simulator wrote
    path = os.path.join(out, 'cli_main.json')
    with open(path, 'wb') as fobj:
        fobj.write(main_saved['json'])
    raw = json.loads(main_saved['json'])
    if not set(DERIVED_KEYS) <= set(raw):
        fail(f'cli rerun: the saved JSON lacks {DERIVED_KEYS}')
    launched, records, run_dir, wall = _cli_run('cli rerun', path)
    add(launched)
    ident = records['tracks']['id']
    data = os.path.join(run_dir, 'data', raw['sim_mode'])
    counts = np.load(os.path.join(data, f'{ident}_counts.npy'))
    summary = np.load(os.path.join(data, 'summary_presence.npy'))
    if records['potential']['solver'] != 'cache':
        fail('cli rerun: the potential was not read from the cache')
    if counts.dtype != main_saved['counts'].dtype or \
            not np.array_equal(counts, main_saved['counts']) or \
            not np.array_equal(summary, main_saved['summary']):
        fail('cli rerun: counts or summary_presence.npy differ from the '
             'main run\'s')
    rerun = {'wall_s': wall, 'steps': records['tracks']['steps'],
             'tracks_s': records['tracks']['seconds'],
             'fused_chunk': launched['fused_chunk'],
             'presence_flush': launched['presence_flush']}
    say(f'cli rerun of the main run from {raw["run_name"]}.json (keys '
        f'{", ".join(DERIVED_KEYS)} included): potential from the cache, '
        f'{rerun["steps"]} steps in {launched["fused_chunk"]} chunk '
        f'launches, {launched["flushes"]} flushes through '
        f'{launched["presence_flush"]} flush launches; counts and '
        f'summary_presence.npy bitwise equal to the main run\'s; '
        f'{wall:.3f} s on {device_name}')

    # the example regions, each from a JSON of Config fields
    regions, sims = {}, {}
    for name, (shape, region, source) in CLI_REGIONS.items():
        label = f'cli {name}'
        cfg = Config(run_name=name, out_dir=out, **CLI_COMMON, **region)
        path = os.path.join(out, f'cli_{name}.json')
        cfg.to_json(path)
        launched, records, run_dir, wall = _cli_run(label, path)
        add(launched)
        pot, trk = records['potential'], records['tracks']
        ident = trk['id']
        case = ident.split('_')[0]
        data = os.path.join(run_dir, 'data', 'uniform')
        names = {f'{case}_orograph.npy', f'{ident}_potential.npy',
                 f'{ident}_tracks.pkl', f'{ident}_counts.npy',
                 'summary_presence.npy'}
        if set(os.listdir(data)) != names:
            fail(f'{label}: artifacts {sorted(os.listdir(data))}')
        counts = np.load(os.path.join(data, f'{ident}_counts.npy'))
        summary = np.load(os.path.join(data, 'summary_presence.npy'))
        if counts.shape != shape or counts.dtype != np.int32 or \
                counts.min() < 0 or summary.shape != shape or \
                summary.max() != 1.0:
            fail(f'{label}: counts {counts.dtype} {counts.shape} or the '
                 f'summary (max {summary.max()}) are not those of a '
                 f'{shape[0]}x{shape[1]} run')
        mass = int(counts.sum(dtype=np.int64))
        # every track lives through the burn-in (min(shape) // 10 steps)
        floor = cfg.track_count * (min(shape) // 10 + 1)
        if mass < floor:
            fail(f'{label}: presence mass {mass} < {floor}')
        if not trk.get('recorded') or trk['builder'] != 'native':
            fail(f'{label}: the tracks phase did not record with the C++ '
                 'builder')
        with open(os.path.join(data, f'{ident}_tracks.pkl'), 'rb') as fobj:
            tracks = pickle.load(fobj)
        rows, cols = track_points(tracks, torch.device('cuda'))
        recount = presence_histogram_batch(rows, cols, *shape)
        if len(tracks) != cfg.track_count or \
                not np.array_equal(recount.cpu().numpy(), counts):
            fail(f'{label}: _counts.npy differs from the recount of its '
                 f'{len(tracks)} tracks')
        # both kernels held against their plain versions at the region's
        # shapes: C on the .pkl's points, A from the region's own starts
        count_err = int((recount - presence_histogram_batch_plain(
            rows, cols, *shape)).abs().max())
        if count_err:
            fail(f'{label}: the count of the .pkl differs from the plain '
                 f'count by {count_err}')
        sims[name] = Simulator(cfg)
        chunk_err, n, live, cells, pending = _chunk_against_plain(
            torch, sims[name], label)
        phases = {k: records[k]['seconds'] for k in (
            'terrain', 'updrafts', 'potential', 'tracks', 'write_tracks',
            'simulate_tracks', 'presence_map')}
        regions[name] = {
            'grid': list(shape), 'source': source, 'wall_s': wall,
            'phases_s': phases,
            'solver': {k: pot[k] for k in ('solver', 'rrel', 'vcycles',
                                           'fallback', 'passes')},
            'steps': trk['steps'], 'useful_steps': trk['useful_steps'],
            'chunks': math.ceil(trk['steps'] / DRIVER_CHUNK),
            'fused_chunk': launched['fused_chunk'],
            'flushes': launched['flushes'],
            'presence_flush': launched['presence_flush'], 'mass': mass,
            'count_points': int(rows.numel()),
            'count_max_abs_err': count_err,
            'chunk_against_plain': {'agents': n, 'steps': CHUNK_T,
                                    'live_agent_steps': live,
                                    'cells': cells,
                                    'max_abs_err': chunk_err,
                                    'flush_pending': pending}}
        say(f'{label}: the count kernel on the .pkl\'s {rows.numel()} '
            f'points, one {CHUNK_T}-step chunk launch from the region\'s '
            f'{n} starts on its {shape[0] * shape[1]}x9 table ({live} live '
            f'agent-steps, {cells} cells) and its flush ({pending} pending) '
            'are exactly equal to their plain versions')
        say(f'{label} ({shape[0]}x{shape[1]} at {region["resolution"]:g} m, '
            f'{source}): potential {_solver_line(pot).split(" ", 1)[1]}, '
            f'{pot["vcycles"]} V-cycles, fallback {pot["fallback"]}; '
            'phases (s): ' + ', '.join(f'{k} {v:.3f}'
                                       for k, v in phases.items())
            + f'; run {wall:.3f} s; {trk["steps"]} steps: '
            f'{launched["fused_chunk"]} chunk launches for '
            f'{regions[name]["chunks"]} chunks, {launched["presence_flush"]} '
            f'flush launches for {launched["flushes"]} flushes; mass {mass} '
            f'>= {floor}, = the recount of the .pkl; on {device_name}')

    # one region's presence map again, without its _counts.npy: the .pkl
    # recount, one launch of the count kernel
    name = CLI_RECOUNT_REGION
    sim = sims[name]
    ident = sim._get_id_string(sim.case_ids[0], 0)
    counts_path = os.path.join(sim.mode_data_dir, f'{ident}_counts.npy')
    summary_path = os.path.join(sim.mode_data_dir, 'summary_presence.npy')
    before = np.load(summary_path)
    os.replace(counts_path, counts_path + '.moved')
    _reset_counts()
    sim.compute_presence_map()
    recounted = _read_counts()
    os.replace(counts_path + '.moved', counts_path)
    if recounted['presence_histogram_batch'] != 1 or \
            recounted['fused_chunk'] or recounted['fused_step'] or \
            recounted['presence_flush'] or recounted['presence_histogram']:
        fail(f'cli {name}: the presence map from the .pkl launched '
             f'{recounted}, not the count kernel once')
    if not np.array_equal(np.load(summary_path), before):
        fail(f'cli {name}: the presence map from the .pkl differs')
    add(recounted)
    say(f'cli {name}: compute_presence_map() without _counts.npy: one '
        'launch of the count kernel, summary_presence.npy bitwise equal')

    # the figures need matplotlib: without it, run fails before any output
    try:
        import matplotlib.pyplot  # noqa: F401
        import matplotlib
        have_mpl = matplotlib.__version__
    except ImportError:
        have_mpl = None
    name = CLI_RECOUNT_REGION
    if have_mpl is None:
        cfg = Config(run_name='cli_figures', out_dir=out, **CLI_COMMON,
                     **CLI_REGIONS[name][1])
        path = os.path.join(out, 'cli_figures.json')
        cfg.to_json(path)
        try:
            cli_main(['run', path])
        except ImportError as exc:
            error = f'{type(exc).__name__}: {exc}'
        else:
            fail('cli figures: run without matplotlib and without '
                 '--no-plots did not raise')
        if os.path.exists(os.path.join(out, 'cli_figures')):
            fail('cli figures: the run made its directory before it raised')
        say(f'cli figures: matplotlib does not import here; run without '
            f'--no-plots raised {error} before any output directory '
            'existed')
    else:
        launched, _, run_dir, wall = _cli_run(
            'cli figures', os.path.join(out, f'cli_{name}.json'), plots=True)
        add(launched)
        case = sim.case_ids[0]
        want = {'elevation.png', 'slope.png', 'aspect.png',
                f'uniform/{ident}_tracks.png',
                f'uniform/{sim._get_id_string(case)}_presence.png'}
        figs = {os.path.relpath(os.path.join(d, f),
                                os.path.join(run_dir, 'figs'))
                for d, _, files in os.walk(os.path.join(run_dir, 'figs'))
                for f in files}
        if figs != want:
            fail(f'cli figures: {sorted(figs)}, not {sorted(want)}')
        say(f'cli figures: matplotlib {have_mpl}; the {name} run with '
            f'figures wrote {", ".join(sorted(figs))} in {wall:.3f} s')
    return total, {'rerun': rerun, 'regions': regions,
                   'matplotlib': have_mpl}


def _sharded_solve(torch, cond, dirn, mesh, tol=1e-7):
    """(potential on the host, rrel, stats, wall seconds) of one row-sharded
    refined solve over ``mesh``."""
    from ssrs_tpu_torch.parallel import solve_potential_refined_sharded
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    bmask, bvals = boundary_masks(dirn, tuple(cond.shape))
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pot, rrel = solve_potential_refined_sharded(cond, bmask, bvals,
                                                mesh=mesh, tol=tol,
                                                stats=stats)
    pot = pot.gather().cpu().numpy()
    return pot, rrel, stats, time.perf_counter() - t0


def _check_moves(label, stats, shape):
    """No move between shards but the scatter of an input on mesh[0] into
    its blocks carries a sixteenth of a float32 field or more: halo rows,
    partials, scalars and the gathered coarse levels only."""
    field = shape[0] * shape[1] * 4
    big = {k: v['largest'] for k, v in stats['transfers'].items()
           if k != 'scatter' and v['largest'] >= field // 16}
    if big:
        fail(f'{label}: moves between shards of a field block: {big}')


def phase_sharded(torch, device_name, out, sim, solver):
    """The multi-device layer at the main run's width, over a mesh of
    SHARDS entries (every visible card, cycled): the counts-only run of
    100,000 tracks through ``Simulator(device=mesh, mesh_devices=SHARDS)``
    (the potential from the main run's cache), its shards against the
    single-device driver on their slices, one shard's chunk, flush and
    two steps against the plain versions, ``simulate_presence_sharded``
    (the per-step kernel), the direction sweep again from its cache with its
    cases spread over SWEEP_MESH entries, the row-sharded orograph, and
    the row-sharded solve of the main field and of the hard field.
    Returns the launches of the three driven runs, each counted from 0
    just before it, summed, and the phase's numbers."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents.fused_chunk import (fused_chunk,
                                                   fused_chunk_plain)
    from ssrs_tpu_torch.agents.fused_step import (alive_and_push, fused_step,
                                                  fused_step_plain)
    from ssrs_tpu_torch.agents.presence_hist import (presence_flush,
                                                     presence_flush_plain)
    from ssrs_tpu_torch.agents.simulate import (init_state,
                                                simulate_presence_compacting)
    from ssrs_tpu_torch.core.rng import case_seed, fold_in
    from ssrs_tpu_torch.fields.updraft import orographic_updraft_from_dem
    from ssrs_tpu_torch.parallel import (orographic_updraft_from_dem_sharded,
                                         pad_to_multiple,
                                         simulate_presence_sharded)
    from ssrs_tpu_torch.parallel.mesh import shard_maps_compacting
    from ssrs_tpu_torch.potential import solve_potential_direct
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    from ssrs_tpu_torch.potential.direct import interior_residual
    from ssrs_tpu_torch.potential.fields import conductivity_hard
    cards = torch.cuda.device_count()
    mesh = [torch.device('cuda', i % cards) for i in range(SHARDS)]
    distinct = len(set(mesh))
    label = f'sharded ({SHARDS} shards on {distinct} distinct card(s))'
    case = sim.case_ids[0]
    ident = sim._get_id_string(case, 0)
    params, dirp, restr, table, starts = _run_table(torch, sim)
    seed = case_seed(sim.sim_seed, case, 0, 'tracks')
    burnin = sim.grid.burnin_length()
    total = dict.fromkeys(_read_counts(), 0)

    def add(launched):
        for key, n in launched.items():
            total[key] += n

    # the counts-only run on the mesh, through the Simulator
    pot_path = os.path.join(sim.mode_data_dir, f'{ident}_potential.npy')
    root = os.path.join(out, 'sharded')
    data = os.path.join(root, MAIN_CONFIG['run_name'], 'data', 'uniform')
    os.makedirs(data)
    shutil.copy(pot_path, data)
    cfg = Config(out_dir=root, **MAIN_CONFIG, mesh_devices=SHARDS)
    msim = Simulator(cfg, device=mesh)
    _reset_counts()
    msim.simulate_tracks()
    run = _read_counts()
    add(run)
    rec = {r['phase']: r for r in msim.timer.records}
    if rec['potential']['solver'] != 'cache' or \
            rec['tracks']['devices'] != SHARDS or rec['tracks']['recorded']:
        fail(f'{label}: records {rec["potential"]}, {rec["tracks"]}')
    counts = np.load(os.path.join(data, f'{ident}_counts.npy'))
    mass = _check_case_counts(f'{label} run', counts, cfg.track_count,
                              burnin)

    # its shards: the single-device driver on each slice, bit for bit, with
    # as many chunk launches and flushes
    updraft = sim.load_updrafts(case)[0]
    potential = torch.from_numpy(np.load(pot_path)).to(mesh[0])
    maps, steps = shard_maps_compacting(params, starts, seed, updraft,
                                        potential, mesh)
    if not np.array_equal(maps.sum(0, dtype=torch.int32).cpu().numpy(),
                          counts) or rec['tracks']['steps'] != steps.max():
        fail(f'{label}: the Simulator\'s counts are not the sum of the '
             'sharded driver\'s shards')
    padded, valid = pad_to_multiple(starts, SHARDS)
    per = len(padded) // SHARDS
    single = dict.fromkeys(run, 0)
    for i, dev in enumerate(mesh):
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_in(seed, i))
        _reset_counts()
        got, got_steps = simulate_presence_compacting(
            params, padded[i * per:(i + 1) * per], gen, updraft=updraft,
            potential=potential, valid=valid[i * per:(i + 1) * per])
        for key, n in _read_counts().items():
            single[key] += n
        if got_steps != steps[i] or not torch.equal(got.to(mesh[0]),
                                                    maps[i]):
            fail(f'{label}: shard {i} differs from the single-device '
                 'driver on its slice')
    _check_chunk_launches(f'{label} run', run, [int(s) for s in steps])
    _check_flush_launches(f'{label} run', run)
    if any(run[k] != single[k] for k in ('fused_chunk', 'fused_chunk_steps',
                                         'flushes', 'presence_flush')):
        fail(f'{label}: launches {run} against the single-device runs\' '
             f'{single}')
    say(f'{label} run, {cfg.track_count} tracks through the Simulator on '
        f'{[str(d) for d in mesh]}: tracks phase '
        f'{rec["tracks"]["seconds"]:.3f} s, shard steps '
        f'{[int(s) for s in steps]}, '
        f'{run["fused_chunk"]} chunk launches, {run["flushes"]} flushes '
        f'through {run["presence_flush"]} flush launches, mass {mass}; every '
        'shard bit-identical to simulate_presence_compacting on its slice '
        'with the same launches and flushes, on ' + device_name)

    # one shard's first chunk and its flush against the plain versions
    dev = mesh[1 % SHARDS]
    st0 = init_state(params, padded[per:2 * per], valid=valid[per:2 * per],
                     device=dev)
    u = torch.rand((CHUNK_T, per), device=dev, generator=torch.Generator(
        device=dev).manual_seed(2033))
    chunked = []
    for fn in (fused_chunk, fused_chunk_plain):
        st = _fresh(torch, st0)
        fn(table.to(dev), restr.to(dev), dirp.to(dev), st.pos_r, st.pos_c,
           st.mem, st.alive, st.palive, u, st.presence, s0=0, nu=params.nu,
           memory_k=params.memory_k, burnin=params.burnin,
           nsteps=params.nsteps)
        chunked.append(st)
    diff = _state_diff(torch, *chunked)
    chunk_err = int((chunked[0].presence - chunked[1].presence).abs().max())
    if diff or chunk_err:
        fail(f'{label}: shard 1\'s chunk differs from the plain version in '
             f'{diff}')
    st = chunked[0]
    flushed = [st.presence.clone(), st.presence.clone()]
    flags = [presence_flush(st.pos_r, st.pos_c, st.palive, flushed[0]),
             presence_flush_plain(st.pos_r, st.pos_c, st.palive, flushed[1])]
    flush_err = int((flushed[0].long() - flushed[1].long()).abs().max())
    if flush_err or not torch.equal(*flags) or (
            bool(st.palive.any()) and torch.equal(flushed[0], st.presence)):
        fail(f'{label}: shard 1\'s flush differs from the plain version')
    say(f'{label}: shard 1 on {dev}, {per} agents: one {CHUNK_T}-step chunk '
        f'({_live_steps(st0, st)} live agent-steps) and its flush '
        f'({int(st.palive.sum())} pending) exactly equal to the plain '
        'versions')

    # the same shard's per-step kernel (simulate_presence_sharded's): one
    # step from its initial state and one from its state after the chunk,
    # the run's table, against the plain step on the same uniforms
    step_err = 0
    args = (table.to(dev), restr.to(dev), dirp.to(dev))
    ugen = torch.Generator(device=dev).manual_seed(2034)
    for what, st, t in (('its initial state', st0, 0),
                        (f'step {CHUNK_T}', chunked[1], CHUNK_T)):
        alive, pr, pc = alive_and_push(t, st.alive, st.pos_r, st.pos_c, NROW,
                                       NCOL, params.burnin, params.nsteps)
        u1 = torch.rand(per, device=dev, generator=ugen)
        outs = []
        for fn in (fused_step, fused_step_plain):
            pres = st.presence.clone()
            outs.append((*fn(*args, pr, pc, st.pos_r, st.pos_c, alive,
                             st.palive, st.mem, u1, pres, nu=params.nu,
                             memory_k=params.memory_k), pres))
        for name, x, y in zip(('new_r', 'new_c', 'new_mem', 'presence'),
                              *outs):
            err = int((x.long() - y.long()).abs().max())
            step_err = max(step_err, err)
            if err:
                fail(f'{label}: shard 1\'s step from {what}: {name} differs '
                     f'from the plain version (max abs err {err})')
        say(f'{label}: shard 1\'s per-step kernel from {what} '
            f'({int(alive.sum())} alive, {int(st.palive.sum())} counted) '
            'exactly equal to the plain step')

    # the non-compacting sharded driver: the per-step kernel
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_map, plain_steps = simulate_presence_sharded(
        params, starts, seed, updraft=updraft, potential=potential,
        mesh=mesh)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    stepped = _read_counts()
    add(stepped)
    plain_mass = _check_case_counts(f'{label} simulate_presence_sharded',
                                    plain_map.cpu().numpy(),
                                    cfg.track_count, burnin)
    if not plain_steps <= stepped['fused_step'] <= SHARDS * plain_steps or \
            stepped['fused_chunk'] or stepped['flushes'] != SHARDS or \
            stepped['presence_flush'] != SHARDS:
        fail(f'{label}: simulate_presence_sharded launched {stepped} for '
             f'{plain_steps} steps')
    say(f'{label}: simulate_presence_sharded, {cfg.track_count} tracks: '
        f'{plain_steps} steps, {stepped["fused_step"]} per-step launches, '
        f'{stepped["presence_flush"]} flush launches, mass {plain_mass}, '
        f'{plain_s:.3f} s')

    # the direction sweep again from its cache, its cases over SWEEP_MESH
    # entries of the mesh
    scfg = Config(out_dir=out, **{**MAIN_CONFIG, 'run_name': 'wy_sweep'},
                  mesh_devices=SWEEP_MESH)
    ssim = Simulator(scfg, device=mesh)
    cases = [f's10d{int(d)}' for d in SWEEP_DIRNS]

    def sweep_counts():
        return [np.load(os.path.join(
            ssim.mode_data_dir, f'{ssim._get_id_string(c, 0)}_counts.npy'))
            for c in cases]

    before = sweep_counts()
    _reset_counts()
    ssim.simulate_direction_sweep(SWEEP_DIRNS)
    swept = _read_counts()
    add(swept)
    hits = sum(r['solver'] == 'cache' for r in ssim.timer.records
               if r['phase'] == 'potential')
    brec = [r for r in ssim.timer.records
            if r['phase'] == 'batched_tracks'][0]
    _check_batched_launches(f'{label} sweep', swept, brec)
    if hits != len(cases) or brec['devices'] != SWEEP_MESH or any(
            not np.array_equal(a, b) for a, b in zip(sweep_counts(), before)):
        fail(f'{label} sweep: {hits} cache hits, record {brec}, or counts '
             'that differ from the sweep\'s')
    say(f'{label} sweep: {len(cases)} directions from the cache with the '
        f'cases over {SWEEP_MESH} mesh entries: counts bit for bit the '
        f'sweep\'s, batched track phase {brec["seconds"]:.3f} s, '
        f'{swept["fused_chunk"]} chunk launches, {swept["flushes"]} flushes')

    # the row-sharded orograph
    z = sim.get_terrain_elevation().astype(np.float32)
    wind = [torch.tensor(float(v), device=mesh[0]) for v in
            (sim.uniform_windspeed, sim.uniform_winddirn)]
    want = orographic_updraft_from_dem(torch.from_numpy(z).to(mesh[0]),
                                       sim.resolution, *wind)
    oro = orographic_updraft_from_dem_sharded(
        z, sim.resolution, sim.uniform_windspeed, sim.uniform_winddirn,
        mesh=mesh).gather()
    if not torch.equal(oro, want):
        fail(f'{label}: the row-sharded orograph differs from the '
             'single-device one')
    say(f'{label}: the row-sharded orograph of the {NROW}x{NCOL} DEM is '
        'bitwise the single-device one')

    # the row-sharded solve of the main field: the main solve's invariants
    dirn = float(sim.track_direction)
    cond = updraft
    pot_main = np.load(pot_path)
    solves = [_sharded_solve(torch, cond, dirn, mesh, sim.potential_tol)
              for _ in range(2)]
    pot, rrel, stats, secs = solves[0]
    bmask, bvals = boundary_masks(dirn, pot.shape)
    resid = interior_residual(pot, cond.cpu().numpy(), dirn)
    if not (rrel < RREL_MAX and resid <= INTERIOR_RESID_MAX) or \
            pot.min() < -RANGE_SLACK or pot.max() > 1000. + RANGE_SLACK or \
            not np.array_equal(pot[bmask], bvals[bmask]):
        fail(f'{label}: main-field solve rrel {rrel:.3e}, interior residual '
             f'{resid:.3e}, range {pot.min()}..{pot.max()} or boundary off')
    if not np.array_equal(solves[1][0], pot) or solves[1][1] != rrel:
        fail(f'{label}: two sharded solves of the main field differ')
    _check_moves(f'{label} main-field solve', stats, pot.shape)
    gap = float(np.abs(pot.astype(np.float64) - pot_main).max())
    say(f'{label} solve, main field {NROW}x{NCOL}: rrel {rrel:.3e}, '
        f'{stats["passes"]} passes, {stats["vcycles"]} V-cycles '
        f'({stats["sharded_levels"]} levels sharded), interior residual '
        f'{resid:.3e}, bitwise equal re-solve; {secs:.3f} / '
        f'{solves[1][3]:.3f} s against the single-device solve\'s warm '
        f'{solver["warm_s"][0]:.3f} / {solver["warm_s"][1]:.3f} s and '
        f'{solver["vcycles"]} V-cycles; |sharded - single| max {gap:.4g} '
        f'(not gated: the near-null mode); moves between shards '
        f'{stats["transfers"]}')

    # the hard field against the direct solve
    hard = conductivity_hard(HARD_SHAPE, seed=1)
    h_pot, h_rrel, h_stats, h_secs = _sharded_solve(
        torch, torch.from_numpy(hard).to(mesh[0]), 0., mesh)
    h_err = float(np.abs(h_pot.astype(np.float64) - solve_potential_direct(
        hard, 0.)).max())
    if not (h_err < HARD_ERR_MAX and h_rrel < RREL_MAX):
        fail(f'{label}: hard field max err {h_err:.4g}, rrel {h_rrel:.3e}')
    _check_moves(f'{label} hard-field solve', h_stats, HARD_SHAPE)
    single_hard = solver['hard_460']
    say(f'{label} solve, hard field {HARD_SHAPE[0]}x{HARD_SHAPE[1]}: max err '
        f'{h_err:.4g} < {HARD_ERR_MAX} against direct, rrel {h_rrel:.3e}, '
        f'{h_stats["vcycles"]} V-cycles in {h_secs:.3f} s against the '
        f'single-device solve\'s {single_hard["vcycles"]} in '
        f'{single_hard["seconds"]:.3f} s')
    return total, {
        'shards': SHARDS, 'distinct_cards': distinct,
        'mesh': [str(d) for d in mesh],
        'run': {'tracks_s': rec['tracks']['seconds'],
                'shard_steps': [int(s) for s in steps],
                'chunk_launches': run['fused_chunk'],
                'flushes': run['flushes']},
        'chunk_max_abs_err': chunk_err, 'flush_max_abs_err': flush_err,
        'step_max_abs_err': step_err,
        'plain': {'seconds': plain_s, 'steps': plain_steps,
                  'fused_step': stepped['fused_step']},
        'sweep': {'devices': SWEEP_MESH,
                  'batched_tracks_s': brec['seconds'],
                  'chunk_launches': swept['fused_chunk']},
        'solve_main': {'rrel': rrel, 'passes': stats['passes'],
                       'vcycles': stats['vcycles'], 'seconds': secs,
                       'resolve_seconds': solves[1][3],
                       'interior_residual': resid,
                       'max_abs_vs_single': gap,
                       'transfers': stats['transfers']},
        'solve_hard': {'max_abs_err': h_err, 'rrel': h_rrel,
                       'vcycles': h_stats['vcycles'], 'seconds': h_secs}}


def _notebook_cells(name):
    """The code cells of ``notebooks/<name>.ipynb`` by their index in it,
    for the port on the card: ``ssrs_tpu`` replaced by ``ssrs_tpu_torch``,
    without the lines that pin JAX, call an IPython magic or import
    matplotlib (the card's machine has none)."""
    import re
    with open(os.path.join(REPO, 'notebooks', f'{name}.ipynb')) as fobj:
        nb = json.load(fobj)
    cells = {}
    for i, cell in enumerate(nb['cells']):
        if cell['cell_type'] == 'code':
            lines = [line for line in ''.join(cell['source']).splitlines()
                     if not line.startswith(('%', 'import jax', 'jax.'))
                     and 'matplotlib' not in line]
            cells[i] = re.sub(r'\bssrs_tpu\b', 'ssrs_tpu_torch',
                              '\n'.join(lines))
    return cells


def _notebook_names(name, given):
    """The names a notebook's cells bind at their top level to a literal or
    to a ``Config(...)`` or ``replace(...)`` call, evaluated in order;
    the names in ``given`` keep the script's values."""
    import ast
    from ssrs_tpu_torch import Config
    ns = {'Config': Config, 'replace': dataclasses.replace, **given}
    for src in _notebook_cells(name).values():
        for node in ast.parse(src).body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name) or \
                    node.targets[0].id in given:
                continue
            call = node.value
            if isinstance(call, ast.Call) and isinstance(call.func, ast.Name) \
                    and call.func.id in ('Config', 'replace'):
                exec(compile(ast.Module([node], []), name, 'exec'), ns)
                continue
            try:
                ns[node.targets[0].id] = ast.literal_eval(call)
            except ValueError:
                pass
    return ns


def _exec_cells(name, cells, which, ns):
    for i in which:
        exec(compile(cells[i], f'{name}.ipynb, cell {i}', 'exec'), ns)


def _terrain_demo(torch, device_name):
    """terrain_demo.ipynb's cells but its figures (cell 16), in the current
    directory: the root imports, the terrain chain to the synthetic DEM,
    the reprojection, slope and aspect (numpy, so on the CPU), and the
    turbines from the notebook's pandas frame. Then slope and aspect of
    the elevation as a card tensor against the cell's, and the turbines
    from the frame's columns as a dict against the frame's."""
    from ssrs_tpu_torch import (TurbinesUSWTB, compute_aspect_degrees,
                                compute_slope_degrees)
    cells = _notebook_cells('terrain_demo')
    ns = {}
    t0 = time.perf_counter()
    _exec_cells('terrain_demo', cells,
                [i for i in sorted(cells) if 'plt.' not in cells[i]], ns)
    wall = time.perf_counter() - t0
    elevation = ns['elevation']
    if ns['elevation_layer'] != 'SYNTHETIC' or \
            elevation.shape != tuple(ns['gridsize']) or \
            not np.isfinite(elevation).all():
        fail(f'terrain_demo: elevation {ns["elevation_layer"]} '
             f'{elevation.shape}')
    on_card = torch.from_numpy(np.ascontiguousarray(elevation)).cuda()
    errs = {}
    for key, fn in (('slope', compute_slope_degrees),
                    ('aspect', compute_aspect_degrees)):
        got = fn(on_card, ns['resolution'])
        want = ns[key]
        if got.device != on_card.device or got.shape != want.shape:
            fail(f'terrain_demo: {key} {got.device} {tuple(got.shape)}')
        got = got.cpu().numpy()
        errs[key] = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=ORO_RTOL, atol=ORO_ATOL):
            fail(f'terrain_demo: {key} on the card differs from the CPU\'s '
                 f'by {errs[key]:.3g}')
    frame = ns['fixture']
    from_dict = TurbinesUSWTB(ns['bounds'], ns['proj_crs'],
                              min_hubheight=60., out_fpath=None,
                              dataframe={k: frame[k].to_numpy()
                                         for k in frame.columns})
    xs, ys = from_dict.get_locations()
    n_turb = len(ns['turbines'].dframe)
    if type(frame).__module__.split('.')[0] != 'pandas' or not n_turb or \
            not ns['turbines'].dframe.equals(from_dict.dframe) or \
            not np.array_equal(ns['turb_xlocs'], xs) or \
            not np.array_equal(ns['turb_ylocs'], ys):
        fail('terrain_demo: the turbines of the pandas frame and of its '
             'columns as a dict differ')
    say(f'notebooks terrain_demo: {elevation.shape[0]}x{elevation.shape[1]} '
        f'{ns["elevation_layer"]} DEM through Terrain and '
        f'get_raster_in_projected_crs; slope and aspect of the elevation on '
        f'the card against the CPU\'s: max |diff| {errs["slope"]:.3g} and '
        f'{errs["aspect"]:.3g} (rtol {ORO_RTOL:g}, atol {ORO_ATOL:g}); '
        f'TurbinesUSWTB: {n_turb} of {len(frame)} turbines from the pandas '
        f'frame, equal to those of its columns as a dict; cells {wall:.3f} '
        f's on {device_name}')
    return {'grid': list(elevation.shape), 'layer': ns['elevation_layer'],
            'slope_max_abs_err': errs['slope'],
            'aspect_max_abs_err': errs['aspect'], 'turbines': n_turb,
            'cells_s': wall}


def _wtk_demo(device_name):
    """wtk_demo.ipynb's cells but its archive (cell 3, h5py) and its
    figures (cell 9), in the current directory, on a stand-in archive for
    2014 over the notebook's bounds: the sources, the layer probe, the
    frame of one timestamp against the stand-in's values, the
    coordinates."""
    cells = _notebook_cells('wtk_demo')
    given = _notebook_names('wtk_demo', {})
    ns = {}
    _exec_cells('wtk_demo', cells, [1], ns)
    ns['fixture_tpl'] = os.path.join(ns['output_dir'], 'wtk_demo_$YEAR.h5')
    lat, lon = _wtk_sites(given['lonlat_bounds'])
    _add_standin(ns['fixture_tpl'].replace('$YEAR', '2014'), lat, lon, 2014)
    t0 = time.perf_counter()
    _exec_cells('wtk_demo', cells, [2, 4, 6, 7], ns)
    wall = time.perf_counter() - t0
    frame, dtime = ns['wtkdf'], ns['dtime']
    layers = list(ns['wtk_layers'])
    idx = frame['Indices']
    hour = int((dtime - datetime(dtime.year, 1, 1)).total_seconds() // 3600)
    xs, ys = ns['wtk'].get_coordinates()
    bad = [name for name in layers if not np.array_equal(
        frame[name], _wtk_raw(name, hour, lat[idx], lon[idx])
        / WTK_SCALE[name])]
    if ns['WTK'].valid_sources != ('AWS', 'EAGLE', 'EAGLE_LED', 'LOCAL') or \
            sorted(ns['wtk_source'].valid_layers) != sorted(
                ['coordinates'] + WTK_LAYERS) or \
            frame.columns != ['Indices', 'Longitude', 'Latitude'] + layers \
            or not len(frame) or bad or \
            not np.array_equal(frame['Longitude'], lon[idx]) or \
            not np.array_equal(frame['Latitude'], lat[idx]) or \
            not np.array_equal(xs, lon[idx]) or \
            not np.array_equal(ys, lat[idx]):
        fail(f'wtk_demo: the frame of {dtime} or the sources differ '
             f'(layers {bad})')
    say(f'notebooks wtk_demo: WTK.valid_sources, the LOCAL layer probe, '
        f'get_dataframe_for_this_time({dtime}) on {len(frame)} of the '
        f'stand-in\'s {len(lat)} sites: every layer and the coordinates '
        f'equal to the stand-in\'s values; cells {wall:.3f} s on '
        f'{device_name}')
    return {'sites': len(frame), 'hour': hour, 'cells_s': wall}


def _notebook_mass(label, sim):
    """The mass checks on every case's counts: at least every track's
    burn-in, and the points of the ``.pkl`` where the run recorded.
    Returns the masses."""
    floor = sim.track_count * (sim.grid.burnin_length() + 1)
    masses = []
    for case in sim.case_ids:
        for real in range(max(1, int(sim.thermals_realization_count))):
            ident = sim._get_id_string(case, real)
            counts = np.load(os.path.join(sim.mode_data_dir,
                                          f'{ident}_counts.npy'))
            mass = int(counts.sum(dtype=np.int64))
            if counts.shape != tuple(sim.gridsize) or \
                    counts.dtype != np.int32 or counts.min() < 0 or \
                    mass < floor:
                fail(f'{label} {ident}: counts {counts.dtype} '
                     f'{counts.shape}, mass {mass} < {floor}')
            pkl = os.path.join(sim.mode_data_dir, f'{ident}_tracks.pkl')
            if os.path.exists(pkl):
                with open(pkl, 'rb') as fobj:
                    tracks = pickle.load(fobj)
                if len(tracks) != sim.track_count or \
                        mass != sum(len(t) for t in tracks):
                    fail(f'{label} {ident}: counts mass {mass} != the '
                         f'points of its {len(tracks)} tracks')
            masses.append(mass)
    return masses


def _stalled_solves(label, sim, pots):
    """The refined solves of ``pots`` that ended unconverged but inside the
    net; up to STALL_DIRECT_MAX_CELLS each against the host direct
    solve."""
    from ssrs_tpu_torch.potential import solve_potential_direct
    out = []
    for rec in pots:
        if rec['solver'] != 'refined' or rec['fallback'] or \
                not STALL_RREL[0] < rec['rrel'] <= STALL_RREL[1]:
            continue
        stall = {'id': rec['id'], 'rrel': rec['rrel'],
                 'grid': list(sim.gridsize)}
        if np.prod(sim.gridsize) <= STALL_DIRECT_MAX_CELLS:
            case, real = rec['id'].split('_')[0], int(
                rec['id'].rsplit('_r', 1)[1])
            cond = sim.load_updrafts(case, device=False)[real]
            pot = np.load(os.path.join(sim.mode_data_dir,
                                       f'{rec["id"]}_potential.npy'))
            t0 = time.perf_counter()
            want = solve_potential_direct(cond, sim.track_direction)
            diff = np.abs(pot.astype(np.float64) - want)
            stall.update(max_abs=float(diff.max()), mean_abs=float(
                diff.mean()), direct_s=time.perf_counter() - t0)
        against = '' if 'max_abs' not in stall else (
            f'; against the host direct solve max |diff| '
            f'{stall["max_abs"]:.4g}, mean {stall["mean_abs"]:.4g} '
            f'({stall["direct_s"]:.1f} s)')
        say(f'{label}: {rec["id"]} stalled at rrel {rec["rrel"]:.2e} inside '
            f'the 5e-3 net{against}')
        out.append(stall)
    return out


def phase_notebooks(torch, device_name, out, template):
    """The notebooks through the port on the card: terrain_demo and
    wtk_demo (their cells), then every configuration of ssrs_tpu_demo
    (at its own size), workshop_cases and ssrs_modes (at NOTEBOOK_RES),
    read from the notebooks' JSON, each through ``Simulator(config)`` and
    ``simulate_tracks()``; the WTK cases on stand-ins of their regions
    and years. Gates: the mass checks of every case, kernel C's recount
    of one ``.pkl`` and, at the largest grid, one chunk launch from the
    case's own starts and its flush, exact against the plain versions."""
    from ssrs_tpu_torch import Simulator
    from ssrs_tpu_torch.agents.presence import track_points
    from ssrs_tpu_torch.agents.presence_hist import (
        presence_histogram_batch, presence_histogram_batch_plain)
    t_phase = time.perf_counter()
    nb_dir = os.path.join(out, 'notebooks')
    os.makedirs(nb_dir)
    cwd = os.getcwd()
    os.chdir(nb_dir)
    try:
        terrain = _terrain_demo(torch, device_name)
        wtk = _wtk_demo(device_name)
    finally:
        os.chdir(cwd)

    # the stand-ins the WTK cases read: Altamont Pass for 2012, the README
    # region (ssrs_modes's) for 2014 beside phase_wtk_archive's 2012
    alt_tpl = os.path.join(nb_dir, 'wtk_alt_$YEAR.h5')
    given = {'workshop_cases': {'RES': NOTEBOOK_RES, 'output_dir': nb_dir,
                                'fixture_tpl': alt_tpl},
             'ssrs_modes': {'output_dir': nb_dir, 'fixture_tpl': template},
             'ssrs_tpu_demo': {}}
    configs = {}
    for name, labels in NOTEBOOK_RUNS:
        ns = _notebook_names(name, given[name])
        for label in labels:
            cfg = dataclasses.replace(ns[label], out_dir=nb_dir)
            if name == 'ssrs_modes':
                cfg = dataclasses.replace(cfg, resolution=NOTEBOOK_RES)
            configs[label] = (name, cfg)
    alt = configs['alt_test1'][1]
    _add_standin(alt_tpl.replace('$YEAR', '2012'),
                 *_wtk_sites(_region_lonlat_bounds(alt)), 2012)
    _add_standin(template.replace('$YEAR', '2014'), *_wtk_sites(), 2014)

    total = dict.fromkeys(_read_counts(), 0)
    runs, stalls, gates = {}, [], {}
    for label, (name, cfg) in configs.items():
        _reset_counts()
        t0 = time.perf_counter()
        sim = Simulator(cfg)
        sim.simulate_tracks()
        wall = time.perf_counter() - t0
        launched = _read_counts()
        for key, n in launched.items():
            total[key] += n
        recs = sim.timer.records
        pots = [r for r in recs if r['phase'] == 'potential']
        steps = [s for r in recs if r['phase'] in ('tracks', 'batched_tracks')
                 for s in np.atleast_1d(r['steps']).tolist()]
        _check_chunk_launches(f'{name} {label}', launched, steps)
        _check_flush_launches(f'{name} {label}', launched)
        masses = _notebook_mass(f'{name} {label}', sim)
        runs[label] = {
            'notebook': name, 'run_name': cfg.run_name,
            'sim_mode': cfg.sim_mode, 'grid': list(sim.gridsize),
            'tracks': cfg.track_count, 'cases': len(sim.case_ids),
            'wall_s': wall,
            'solve_s': sum(r['seconds'] for r in pots),
            'solves': [{k: r[k] for k in ('id', 'solver', 'rrel', 'fallback',
                                          'seconds', 'vcycles')}
                       for r in pots],
            'steps': steps, 'mass': masses,
            'fused_chunk': launched['fused_chunk'],
            'presence_flush': launched['presence_flush']}
        say(f'notebooks {name} {label} ({cfg.run_name}, {cfg.sim_mode}, '
            f'{sim.gridsize[0]}x{sim.gridsize[1]} at {cfg.resolution:g} m, '
            f'{len(sim.case_ids)} case(s) x {cfg.track_count} tracks): run '
            f'{wall:.3f} s, solves ' + '; '.join(
                _solver_line(r).split(' ', 1)[1] + f' {r["vcycles"]} '
                'V-cycles' for r in pots)
            + f'; steps {steps}: {launched["fused_chunk"]} chunk launches, '
            f'{launched["presence_flush"]} flush launches for '
            f'{launched["flushes"]} flushes; mass {masses} on {device_name}')
        stalls += _stalled_solves(f'notebooks {label}', sim, pots)

        # the gates, whose launches the run's counts leave out
        if label == NOTEBOOK_CHUNK:
            err, n, live, cells, pending = _chunk_against_plain(
                torch, sim, f'notebooks {label}')
            gates['chunk'] = {'run': label, 'grid': list(sim.gridsize),
                              'agents': n, 'steps': CHUNK_T,
                              'live_agent_steps': live, 'cells': cells,
                              'max_abs_err': err, 'flush_pending': pending,
                              'flush_max_abs_err': 0}
            say(f'notebooks {label}: one {CHUNK_T}-step chunk launch from '
                f'the case\'s {n} starts on its '
                f'{sim.gridsize[0] * sim.gridsize[1]}x9 table ({live} live '
                f'agent-steps, {cells} cells) and its flush ({pending} '
                'pending) exactly equal to the plain versions')
        if label == NOTEBOOK_RECOUNT:
            ident = sim._get_id_string(sim.case_ids[0], 0)
            with open(os.path.join(sim.mode_data_dir,
                                   f'{ident}_tracks.pkl'), 'rb') as fobj:
                tracks = pickle.load(fobj)
            counts = np.load(os.path.join(sim.mode_data_dir,
                                          f'{ident}_counts.npy'))
            rows, cols = track_points(tracks, torch.device('cuda'))
            recount = presence_histogram_batch(rows, cols, *sim.gridsize)
            err = int((recount - presence_histogram_batch_plain(
                rows, cols, *sim.gridsize)).abs().max())
            if err or not np.array_equal(recount.cpu().numpy(), counts):
                fail(f'notebooks {label}: the count of the .pkl differs from '
                     f'the plain count by {err}, or from _counts.npy')
            gates['count'] = {'run': label, 'points': int(rows.numel()),
                              'max_abs_err': err}
            say(f'notebooks {label}: the count kernel on the .pkl\'s '
                f'{rows.numel()} points exactly equal to the plain count and '
                'to _counts.npy')
    phase_s = time.perf_counter() - t_phase
    n_solves = sum(len(r['solves']) for r in runs.values())
    say(f'notebooks: {len(runs)} runs, {n_solves} potentials, '
        f'{len(stalls)} refined solves stalled inside the net (rrel in '
        f'({STALL_RREL[0]:g}, {STALL_RREL[1]:g}]); {total["fused_chunk"]} '
        f'chunk launches, {total["presence_flush"]} flush launches; phase '
        f'{phase_s:.1f} s on {device_name}')
    return total, {'terrain_demo': terrain, 'wtk_demo': wtk, 'runs': runs,
                   'gates': gates, 'stalled_solves': stalls,
                   'phase_s': phase_s}


class _Probe:
    """Wraps functions and methods of the port to count their calls and
    add up their seconds, each call closed by a device synchronize, and to
    keep the peak device memory of each (nested calls included: a call's
    peak is the largest ``max_memory_allocated`` seen between its start
    and its end, across the resets its inner calls make)."""

    def __init__(self, torch):
        self.torch = torch
        self.stats = {}
        self._undo = []
        self._open = []

    def wrap(self, owner, name, label):
        orig = getattr(owner, name)
        probe = self

        def timed(*args, **kwargs):
            with probe.span(label):
                return orig(*args, **kwargs)

        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def restore(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    @contextlib.contextmanager
    def span(self, label):
        cuda = self.torch.cuda
        cuda.synchronize()
        if self._open:
            self._open[-1] = max(self._open[-1], cuda.max_memory_allocated())
        cuda.reset_peak_memory_stats()
        self._open.append(0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = max(self._open.pop(), cuda.max_memory_allocated())
            if self._open:
                self._open[-1] = max(self._open[-1], peak)
            rec = self.stats.setdefault(label, {'calls': 0, 'seconds': 0.,
                                                'peak_gb': 0.})
            rec['calls'] += 1
            rec['seconds'] += secs
            rec['peak_gb'] = max(rec['peak_gb'], peak / 1e9)

    def line(self, *labels):
        return ', '.join(
            f'{k} {self.stats[k]["seconds"]:.3f} s'
            + (f' x{self.stats[k]["calls"]}' if self.stats[k]['calls'] > 1
               else '') + f' (peak {self.stats[k]["peak_gb"]:.2f} GB)'
            for k in labels if k in self.stats)


def _large_probe(torch):
    """The probe of the large run: the host's reprojection of the DEM and
    its CRS transform, the Horn stencil and the updraft on the card, the
    solve's host work (island labels, their per-level layouts and
    coarsening) and its device parts (levels, refinement), the residual
    net and the potential's copy to the host, the weight
    table, the counts-only driver, the smoothing and the summary's
    normalize and save."""
    import ssrs_tpu_torch.agents.simulate as simulate_mod
    import ssrs_tpu_torch.data.raster as raster_mod
    import ssrs_tpu_torch.plotting as plotting_mod
    import ssrs_tpu_torch.potential.lap as lap
    import ssrs_tpu_torch.simulator as sim_mod
    probe = _Probe(torch)
    sim_cls = sim_mod.Simulator
    for owner, name, label in (
            (sim_mod, 'get_raster_in_projected_crs', 'reproject'),
            (raster_mod, 'transform_coordinates', 'crs_transform'),
            (sim_mod, 'compute_slope_aspect_degrees', 'horn'),
            (sim_mod, 'compute_orographic_updraft', 'updraft'),
            (sim_cls, '_begin_potential_solve', 'solve'),
            (lap, 'island_labels', 'island_labels'),
            (lap, 'build_lap_levels', 'levels'),
            (lap, 'island_segments', 'island_segments'),
            (lap, '_host_coarsen_labels', 'coarsen_labels'),
            (lap, '_refine', 'refine'),
            (sim_cls, '_finish_potential_solve_pair', 'net_and_copy'),
            (simulate_mod, 'prepared_weights', 'table'),
            (sim_cls, '_run_large', 'driver'),
            (plotting_mod, 'smooth_presence', 'smooth'),
            (sim_cls, '_finish_summary_presence', 'summary_save')):
        probe.wrap(owner, name, label)
    return probe


def _large_fields(torch, sim):
    """Slope and aspect of the Simulator's DEM (reprojected once a run;
    its second ``get_terrain_elevation()`` timed) on the card, and the
    saved orograph, against the same functions on the CPU, in row bands
    of the DEM with a halo row on each side, within the fields' gate.
    Returns the largest differences and the seconds of that call."""
    from ssrs_tpu_torch.fields import (compute_orographic_updraft,
                                       compute_slope_aspect_degrees)
    oro = np.load(sim._get_orograph_fname(sim.case_ids[0],
                                          sim.mode_data_dir) + '.npy')
    t0 = time.perf_counter()
    dem = sim.get_terrain_elevation()
    dem_s = time.perf_counter() - t0
    slope, aspect = compute_slope_aspect_degrees(
        torch.from_numpy(dem.astype(np.float32)).cuda(), sim.resolution)
    nrow = dem.shape[0]
    errs = {'slope': 0., 'aspect': 0., 'updraft': 0.}
    for r0 in range(0, nrow, LARGE_BAND_ROWS):
        r1 = min(nrow, r0 + LARGE_BAND_ROWS)
        lo, hi = max(0, r0 - 1), min(nrow, r1 + 1)
        s, a = compute_slope_aspect_degrees(
            torch.from_numpy(dem[lo:hi].astype(np.float32)), sim.resolution)
        w = compute_orographic_updraft(
            torch.full_like(s, float(sim.uniform_windspeed)),
            torch.full_like(s, float(sim.uniform_winddirn)), s, a)
        band = slice(r0 - lo, r1 - lo)
        for key, got, want in (('slope', slope[r0:r1].cpu().numpy(), s),
                               ('aspect', aspect[r0:r1].cpu().numpy(), a),
                               ('updraft', oro[r0:r1], w)):
            want = want[band].numpy()
            errs[key] = max(errs[key], float(np.abs(got - want).max()))
            if not np.allclose(got, want, rtol=ORO_RTOL, atol=ORO_ATOL):
                fail(f'large run: {key} of rows {r0}..{r1} on the card '
                     f'differs from the CPU\'s by {errs[key]:.3g}')
    return errs, dem_s


def crop_against_direct(torch, field, r0, c0, size, dirn, tol):
    """The ``size`` x ``size`` window of ``field`` (a conductivity, numpy)
    at row ``r0``, column ``c0`` solved alone by the refined solver on
    the card and by the host's direct solve, with track direction
    ``dirn``: {'crop', 'rrel', 'passes', 'vcycles', 'seconds', 'direct_s',
    'max_abs_vs_direct', 'mean_abs_vs_direct' and the mean over the cells
    with conductivity > 0, 'cond_pos_share'}."""
    from ssrs_tpu_torch.potential import (boundary_masks,
                                          solve_potential_direct,
                                          solve_potential_refined)
    cond = np.ascontiguousarray(field[r0:r0 + size, c0:c0 + size])
    bmask, bvals = boundary_masks(dirn, cond.shape)
    t0 = time.perf_counter()
    want = solve_potential_direct(cond, dirn).astype(np.float64)
    direct_s = time.perf_counter() - t0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, rrel = solve_potential_refined(torch.from_numpy(cond).cuda(),
                                        bmask, bvals, tol=tol, stats=stats)
    diff = np.abs(got.cpu().numpy().astype(np.float64) - want)
    pos = cond > 0
    return {'crop': [r0, c0, size], 'rrel': rrel, 'passes': stats['passes'],
            'vcycles': stats['vcycles'],
            'seconds': time.perf_counter() - t0, 'direct_s': direct_s,
            'max_abs_vs_direct': float(diff.max()),
            'mean_abs_vs_direct': float(diff.mean()),
            'mean_abs_vs_direct_cond_pos': float(diff[pos].mean()),
            'cond_pos_share': float(pos.mean())}


def _large_solve(torch, sim, probe):
    """``simulate_tracks()`` of the large run up to its potential: the
    refined solve, and the net's verdict. Returns {'rrel', 'passes',
    'vcycles', 'seconds', 'refused': the ``RuntimeError``'s message or
    None}. A refusal must name the grid and the rrel above the net, and
    the stalled potential must be finite with an exact boundary; it is
    then written to the run's potential cache (see :func:`phase_large`).
    No kernel of the tracks may launch before."""
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    handles = []
    begin = sim._begin_potential_solve

    def keep(conductivity):
        handles.append(begin(conductivity))
        return handles[-1]

    sim._begin_potential_solve = keep
    _reset_counts()
    refused = None
    try:
        with probe.span('solve_or_refuse'):
            sim.simulate_tracks()
    except RuntimeError as err:
        refused = str(err)
    finally:
        del sim._begin_potential_solve
    if len(handles) != 1 or handles[0][0] != 'refined':
        fail(f'large run: {len(handles)} solves, not one refined solve')
    _, (_, dev_pot, rrel), info = handles.pop()
    out = {'rrel': float(rrel), 'passes': info['passes'],
           'vcycles': info['vcycles'], 'seconds': info['seconds'],
           'refused': refused}
    if refused is None:
        return out
    launched = _read_counts()
    if any(launched.values()) or float(rrel) <= LARGE_RREL_MAX or \
            f'stalled (rrel {float(rrel):.2e}) on a {LARGE_GRID[0]}x' \
            f'{LARGE_GRID[1]} grid' not in refused:
        fail(f'large run: refused with "{refused}" at rrel {float(rrel)}, '
             f'launches {launched}')
    pot = dev_pot.cpu().numpy()
    del dev_pot
    bmask, bvals = boundary_masks(float(sim.track_direction), pot.shape)
    if pot.shape != LARGE_GRID or not np.isfinite(pot).all() or \
            not np.array_equal(pot[bmask], bvals[bmask]):
        fail(f'large run: stalled potential {pot.shape}, range '
             f'{np.nanmin(pot)}..{np.nanmax(pot)}')
    fname = sim._get_potential_fname(sim.case_ids[0], 0, sim.mode_data_dir)
    np.save(f'{fname}.npy', pot)
    torch.cuda.empty_cache()
    return out


def _large_chunk_times(torch, run, dev):
    """The chunk kernel on the large run's table (``run``, from
    :func:`_run_table`), from the run's starts: one CHUNK_T-step launch
    at step 0 and one at LARGE_LATE_STEP (the state brought there by
    launches of the kernel), each timed three times from the same state
    with the same uniforms. Returns, for each, the median ms, the live
    agent-steps, the cells counted, ps a live agent-step and the bound of
    :func:`_chunk_bound`."""
    from ssrs_tpu_torch.agents.fused_chunk import fused_chunk
    from ssrs_tpu_torch.agents.simulate import init_state
    params, dirp, restr, table, starts = run
    gen = torch.Generator(device=dev).manual_seed(2033)
    state = init_state(params, starts, device=dev)
    n = state.pos_r.shape[0]

    def launch(st, u, s0):
        fused_chunk(table, restr, dirp, st.pos_r, st.pos_c, st.mem,
                    st.alive, st.palive, u, st.presence, s0=s0,
                    nu=params.nu, memory_k=params.memory_k,
                    burnin=params.burnin, nsteps=params.nsteps)

    out = {}
    s0 = 0
    for key, at in (('first', 0), ('late', LARGE_LATE_STEP)):
        while s0 < at:
            launch(state, torch.rand((CHUNK_T, n), device=dev,
                                     generator=gen), s0)
            s0 += CHUNK_T
        base = _fresh(torch, state)
        u = torch.rand((CHUNK_T, n), device=dev, generator=gen)
        times = []
        for _ in range(3):
            st = _fresh(torch, base)
            ms, _ = _once_ms(torch, lambda: launch(st, u, at))
            times.append(ms)
        live = _live_steps(base, st)
        cells = int((st.presence > 0).sum())
        bound_ms, bound_by = _chunk_bound(n, params.memory_k,
                                          9 * table.element_size(), live,
                                          cells)
        ms = float(np.median(times))
        out[key] = {'step': at, 'ms': ms, 'times_ms': times, 'agents': n,
                    'live_agent_steps': live, 'cells': cells,
                    'ps_per_live_agent_step': ms * 1e9 / max(live, 1),
                    'bound_ms': bound_ms, 'bound_by': bound_by}
    return out


def phase_large(torch, device_name, out):
    """BASELINE.json's config 5 through the port's ``Simulator`` at full
    size (LARGE_CONFIG: 6667x6667 cells, 100,000 tracks), in ``out``: the
    ctor (the synthetic DEM reprojected, the Horn stencil, the updraft),
    ``simulate_tracks()`` (the refined solve behind the 5e-3 net, the
    bfloat16 table, the counts-only driver), ``compute_presence_map()``
    and ``get_turbine_presence()`` on a fixture of turbines over the
    region, each step timed with its peak device memory, the host's parts
    of each timed on their own (:func:`_large_probe`).

    The refined solve of this field stalls above the 5e-3 net, and past
    ``potential_fallback_max_unknowns`` the ``Simulator`` then refuses the
    run with ``RuntimeError``, as the JAX package does (ROADMAP.md section
    3, fault 4). The phase gates that refusal: the message's grid and
    rrel, and the stalled potential finite with its boundary exact. It
    then writes that potential, which no check has accepted, into the
    run's potential cache and calls ``simulate_tracks()`` again, so that
    the tracks, the presence map and the turbines run at full size on
    the card; their gates hold the port's mechanics, not the potential's
    accuracy. A solve that ends inside the net saves its own potential
    there, and the second call runs on it the same way.

    Gates: the solve refined and either inside the net or refused as
    above; one chunk launch a chunk and a flush launch a flush; the
    counts' mass at least tracks x (burn-in + 1); the first chunk and its
    flush exact against the plain versions; slope, aspect and updraft
    card against CPU; the summary finite, max 1 and equal to the returned
    map; every score the summary at its turbine's cell, and turbines.csv
    the fixture's turbines in the bounds and tall enough."""
    import ssrs_tpu_torch.simulator as sim_mod
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.data import read_csv, transform_coordinates
    t_phase = time.perf_counter()
    cfg = Config(out_dir=out, **LARGE_CONFIG)
    fixture = _turbine_fixture(cfg)
    real_tb = sim_mod.TurbinesUSWTB

    class FixtureTB(real_tb):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dataframe=dict(fixture), **kwargs)

    probe = _large_probe(torch)
    sim_mod.TurbinesUSWTB = FixtureTB
    try:
        with probe.span('ctor'):
            sim = Simulator(cfg)
        if tuple(sim.gridsize) != LARGE_GRID or sim._device_fields_fit(1):
            fail(f'large run: grid {sim.gridsize}, device fields '
                 f'{sim._device_fields_fit(1)}')
        solve = _large_solve(torch, sim, probe)
        _reset_counts()
        with probe.span('simulate_tracks'):
            sim.simulate_tracks()
        launched = _read_counts()
        with probe.span('presence_map'):
            summary = sim.compute_presence_map()
        with probe.span('turbines'):
            scores = sim.get_turbine_presence()
    finally:
        sim_mod.TurbinesUSWTB = real_tb
        probe.restore()
    records = {r['phase']: r for r in sim.timer.records}
    stats = probe.stats

    # the potential the tracks ran on, from the cache: the solve's, or,
    # after the refusal, the stalled one
    pot_rec = records['potential']
    ident = sim._get_id_string(sim.case_ids[0], 0)
    pot = np.load(os.path.join(sim.mode_data_dir, f'{ident}_potential.npy'))
    if pot_rec['solver'] != 'cache' or pot.shape != LARGE_GRID or \
            (not solve['refused'] and not solve['rrel'] <= LARGE_RREL_MAX):
        fail(f'large run: potential record {pot_rec}, solve {solve}')

    # the tracks: the counts-only driver, its launches and mass
    rec = records['tracks']
    steps = rec['steps']
    if rec['recorded'] or rec['devices'] != 1:
        fail(f'large run: tracks record {rec}')
    _check_chunk_launches('large run', launched, steps)
    _check_flush_launches('large run', launched)
    counts = np.load(os.path.join(sim.mode_data_dir, f'{ident}_counts.npy'))
    floor = cfg.track_count * (sim.grid.burnin_length() + 1)
    mass = int(counts.sum(dtype=np.int64))
    if counts.shape != LARGE_GRID or counts.dtype != np.int32 or \
            counts.min() < 0 or mass < floor:
        fail(f'large run: counts {counts.dtype} {counts.shape}, mass {mass} '
             f'< {floor}')
    t0 = time.perf_counter()
    on_card = torch.from_numpy(counts).cuda()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    on_card.cpu()
    copy_s = (t1 - t0, time.perf_counter() - t1)
    del on_card

    # the presence map and the turbines
    saved = np.load(os.path.join(sim.mode_data_dir, 'summary_presence.npy'))
    if summary.shape != LARGE_GRID or not np.isfinite(summary).all() or \
            summary.max() != 1.0 or \
            not np.array_equal(saved, summary.astype(np.float32)):
        fail('large run: summary_presence.npy is not the finite, '
             'max-normalized returned map')
    xs, ys = transform_coordinates('EPSG:4326', cfg.projected_crs,
                                   fixture['xlong'], fixture['ylat'])
    b = sim.bounds
    inside = (xs >= b[0]) & (xs <= b[2]) & (ys >= b[1]) & (ys <= b[3])
    keep = np.nonzero(inside & (fixture['t_hh']
                                >= cfg.turbine_minimum_hubheight))[0]
    table_csv = read_csv(os.path.join(sim.mode_data_dir, 'turbines.csv'))
    if not np.array_equal(table_csv.index, keep) or \
            not 0 < len(keep) < int(inside.sum()) < SNAPSHOT_TURBINES or \
            not table_csv.equals(sim.turbines.dframe):
        fail(f'large run: turbines.csv holds rows {list(table_csv.index)}, '
             f'not {list(keep)}')
    pres = scores['presence']
    xgrid, ygrid = sim.get_terrain_grid()
    at = summary[np.clip(np.searchsorted(ygrid, scores['y']), 0,
                         LARGE_GRID[0] - 1),
                 np.clip(np.searchsorted(xgrid, scores['x']), 0,
                         LARGE_GRID[1] - 1)]
    if len(scores) != len(keep) or sorted(scores.index) != list(keep) or \
            (np.diff(pres) > 0).any() or np.abs(pres - at).max() > 1e-6:
        fail(f'large run: turbine scores {pres}')

    # the fields, card against CPU, and the kernels at these shapes
    t0 = time.perf_counter()
    fields, dem_s = _large_fields(torch, sim)
    fields_s = time.perf_counter() - t0
    crop = crop_against_direct(
        torch, sim.load_updrafts(sim.case_ids[0], device=False)[0],
        (LARGE_GRID[0] - LARGE_CROP) // 2, (LARGE_GRID[1] - LARGE_CROP) // 2,
        LARGE_CROP, float(sim.track_direction), float(sim.potential_tol))
    t0 = time.perf_counter()
    run = _run_table(torch, sim)
    err, n, live, cells, pending = _chunk_against_plain(
        torch, sim, 'large run', run)
    plain_s = time.perf_counter() - t0
    chunk = _large_chunk_times(torch, run, sim.device)
    del run
    torch.cuda.empty_cache()

    useful = rec['useful_steps']
    say(f'large ctor {LARGE_GRID[0]}x{LARGE_GRID[1]}: '
        f'{stats["ctor"]["seconds"]:.3f} s (peak '
        f'{stats["ctor"]["peak_gb"]:.2f} GB): terrain '
        f'{records["terrain"]["seconds"]:.3f} s, updrafts '
        f'{records["updrafts"]["seconds"]:.3f} s; '
        + probe.line('reproject', 'crs_transform', 'horn', 'updraft'))
    say(f'large solve: rrel {solve["rrel"]:.3e}, {solve["vcycles"]} '
        f'V-cycles, {solve["passes"]} passes, {solve["seconds"]:.3f} s ('
        + probe.line('solve', 'island_labels', 'levels', 'island_segments',
                     'coarsen_labels', 'refine', 'net_and_copy')
        + '); ' + (f'refused by the net, as in the JAX package: '
                   f'"{solve["refused"][:120]}..."; the tracks ran on this '
                   'stalled potential from the cache, which no check has '
                   'accepted' if solve['refused'] else 'inside the net')
        + f'; potential {pot.min():.4g}..{pot.max():.4g}, finite, boundary '
        f'exact; its {LARGE_CROP}x{LARGE_CROP} centre solved alone on the '
        f'card: rrel {crop["rrel"]:.3e}, {crop["vcycles"]} V-cycles, '
        f'{crop["seconds"]:.3f} s, against the host direct solve '
        f'({crop["direct_s"]:.3f} s) max |diff| '
        f'{crop["max_abs_vs_direct"]:.4g}, mean '
        f'{crop["mean_abs_vs_direct"]:.4g}')
    say(f'large tracks: {cfg.track_count} tracks, {steps} steps, {useful} '
        f'agent-steps in {rec["seconds"]:.3f} s = '
        f'{useful / rec["seconds"]:.4g} agent-steps/s; '
        f'{launched["fused_chunk"]} chunk launches, {launched["flushes"]} '
        f'flushes through {launched["presence_flush"]} flush launches; '
        + probe.line('simulate_tracks', 'table', 'driver')
        + f'; counts {mass} >= {floor}; map to the card {copy_s[0]:.3f} s, '
        f'back {copy_s[1]:.3f} s')
    say(f'large presence_map (krad {sim._presence_kernel_radius(1000.)}): '
        + probe.line('presence_map', 'smooth', 'summary_save')
        + '; summary finite, max 1, equal to summary_presence.npy')
    say(f'large turbines: {SNAPSHOT_TURBINES} in the fixture, '
        f'{int(inside.sum())} inside the bounds, {len(keep)} scored '
        f'{pres.max():.4f}..{pres.min():.4f}, each the summary at its '
        'cell; ' + probe.line('turbines'))
    say(f'large kernels: the first {CHUNK_T}-step chunk ({n} agents, {live} '
        f'live agent-steps, {cells} cells) and its flush ({pending} pending) '
        f'exact against the plain versions ({plain_s:.3f} s with the '
        'table); chunk ' + '; '.join(
            f'{k} (step {v["step"]}) {v["ms"]:.1f} ms for '
            f'{v["live_agent_steps"]} live agent-steps in {v["cells"]} '
            f'cells = {v["ps_per_live_agent_step"]:.1f} ps each, bound '
            f'{v["bound_ms"] * 1e3:.1f} us ({v["bound_by"]})'
            for k, v in chunk.items())
        + f'; fields card vs CPU in {LARGE_BAND_ROWS}-row bands: max |diff| '
        f'slope {fields["slope"]:.3g}, aspect {fields["aspect"]:.3g}, '
        f'updraft {fields["updraft"]:.3g} ({fields_s:.1f} s, the DEM '
        f'again from the Simulator\'s cache in {dem_s:.3f} s); phase '
        f'{time.perf_counter() - t_phase:.1f} s on {device_name}')
    return launched, {
        'grid': list(LARGE_GRID), 'tracks': cfg.track_count,
        'steps': steps, 'useful_steps': useful,
        'tracks_s': rec['seconds'],
        'potential': {k: solve[k] for k in (
            'rrel', 'passes', 'vcycles', 'seconds', 'refused')},
        'crop': crop, 'dem_cached_s': dem_s,
        'probe': stats, 'map_copy_s': copy_s,
        'chunk_max_abs_err': err, 'flush_pending': pending,
        'chunk': chunk, 'fields_max_abs_err': fields,
        'turbines': {'fixture': SNAPSHOT_TURBINES,
                     'inside': int(inside.sum()), 'scored': len(keep)},
        'phase_s': time.perf_counter() - t_phase}


def _check_imports(offline, packages):
    """Fails if a module of ``packages`` was imported, or a ``requests``
    other than the script's own refusing one."""
    bad = [m for m in sys.modules if m.split('.')[0] in packages]
    if bad or sys.modules.get('requests') is not offline:
        fail(f'imported through the port: {bad or "requests"}')


def main() -> int:
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device')
    if not os.path.isfile(os.path.join(REPO, 'ssrs_tpu_torch',
                                       '__init__.py')):
        fail('ssrs_tpu_torch is not beside this script')
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    offline = _refuse_http()
    name = phase_device(torch)
    phase_build()
    max_err, timing = phase_kernel(torch)
    chunk_err = phase_chunk(torch)
    no_table = phase_no_table(torch)
    hist = phase_hist(torch)
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        main_run, sim = phase_main(torch, name, out)
        main_saved = _saved_run(sim)
        solver = phase_solver(torch, sim, name)
        engine = phase_chunk_main(torch, sim, name)
        recorded, count_real = phase_recorded(torch, name, out)
        thermals = phase_thermals(torch, sim)
        sweep_run, sweep = phase_sweep(torch, name, out)
        options_run, options = phase_solver_options(
            torch, name, out, sim, main_saved, solver, sweep)
        thermals_run, thermals_path = phase_thermals_run(torch, name, out)
        drw_run, drw = phase_drw(torch, name, out)
        template, wtk_reads = phase_wtk_archive(out)
        seasonal_run, seasonal = phase_seasonal(torch, name, out, template,
                                                wtk_reads)
        snapshot_run, snapshot = phase_snapshot(torch, name, out, template)
        cli_run, cli = phase_cli(torch, name, out, main_saved)
        sharded_run, sharded = phase_sharded(torch, name, out, sim, solver)
        large_run, large = phase_large(torch, name, out)
        # the port took in no pandas up to here; the notebooks' cells
        # import it themselves
        _check_imports(offline, ('jax', 'jaxlib', 'ssrs_tpu', 'pandas'))
        notebooks_run, notebooks = phase_notebooks(torch, name, out,
                                                   template)
    phase_small(torch)
    # the port took in no JAX, and no requests either: the only
    # ``requests`` is the script's own, which refuses
    _check_imports(offline, ('jax', 'jaxlib', 'ssrs_tpu'))
    bf16, f32 = timing['bfloat16'], timing['float32']
    flush_real, flush_syn = engine['flush_real'], hist['presence_flush']
    count_syn = hist['presence_histogram_batch']
    # the example regions' shapes: A and C against their plain versions
    cli_chunk_err = max(r['chunk_against_plain']['max_abs_err']
                        for r in cli['regions'].values())
    cli_count_err = max(r['count_max_abs_err']
                        for r in cli['regions'].values())
    kernels = [{
        'name': 'fused_step', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/fused_step.cu',
        'replaces': 'ssrs_tpu/agents/fused_step.py:52',
        # its path: the per-step driver simulate_presence
        'path': 'simulate_presence',
        'launches': engine['per_step_path_launches']['fused_step'],
        'max_abs_err': max(max_err, no_table['max_abs_err'],
                           sharded['step_max_abs_err']),
        'ms': bf16['ms'],
        'plain_ms': bf16['plain_ms'], 'bound_ms': bf16['bound_ms'],
        'bound_by': bf16['bound_by'], 'library_ms': None,
        'ms_float32': f32['ms'], 'plain_ms_float32': f32['plain_ms'],
        'launches_no_table':
            drw['per_step_driver']['fused_step_launches']}, {
        'name': 'fused_chunk', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/fused_chunk.cu',
        'replaces': 'ssrs_tpu/agents/fused_step.py:52',
        'path': 'uniform run (simulate_presence_compacting)',
        'launches': main_run['fused_chunk'],
        'max_abs_err': max(chunk_err, no_table['max_abs_err'],
                           cli_chunk_err, sharded['chunk_max_abs_err'],
                           large['chunk_max_abs_err']),
        'ms': engine['chunk_ms'],
        'plain_ms': engine['plain_ms'], 'bound_ms': engine['bound_ms'],
        'bound_by': engine['bound_by'], 'library_ms': None,
        'steps': CHUNK_T, 'per_step_ms': engine['per_step_device_ms'],
        'uniform_draw_ms': engine['uniform_draw_ms'],
        # the large run's table (6667x6667, bf16), first and late chunk
        'large': large['chunk'],
        # the branch without a table (the directed random walk), on
        # synthetic states at the same width
        'no_table': no_table}, {
        # times on the main field's state after one chunk; beside them the
        # 100k synthetic points and the flush it replaced
        'name': 'presence_flush', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/presence_hist.cu',
        'replaces': 'ssrs_tpu/agents/pallas_hist.py:31',
        'computes': 'ssrs_tpu/agents/simulate.py:341 (flush_pending)',
        'path': 'uniform run (flush_pending)',
        'launches': main_run['presence_flush'],
        'max_abs_err': max(flush_real['max_abs_err'],
                           flush_syn['max_abs_err'],
                           sharded['flush_max_abs_err']),
        'ms': flush_real['ms'], 'plain_ms': flush_real['plain_ms'],
        'bound_ms': flush_real['bound_ms'],
        'bound_by': flush_real['bound_by'],
        'library_ms': flush_real['library_ms'],
        'bincount_ms': flush_real['bincount_ms'],
        'host_ms': flush_real['host_ms'],
        'old_flush_ms': flush_real['old_flush_ms'],
        'old_flush_host_ms': flush_real['old_flush_host_ms'],
        'old_kernel_ms': flush_real['old_kernel_ms'],
        'synthetic': flush_syn}, {
        'name': 'presence_histogram', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/presence_hist.cu',
        'replaces': 'ssrs_tpu/agents/pallas_hist.py:31',
        'path': None,
        'launches': main_run['presence_histogram'],
        **{k: hist['presence_histogram'][k] for k in (
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms', 'bincount_ms')}}, {
        # times on the recorded run's own .pkl points; beside them the
        # 6.4M synthetic points, each kernel in turns
        'name': 'presence_histogram_batch', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/presence_hist.cu',
        'replaces': 'ssrs_tpu/agents/pallas_hist.py:59',
        'path': "get_presence_counts' .pkl fallback",
        'launches': recorded['presence_histogram_batch'],
        'max_abs_err': max(count_real['max_abs_err'],
                           count_syn['max_abs_err'], cli_count_err),
        **{k: count_real[k] for k in (
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'bincount_ms', 'plan', 'kernels_ms', 'host_ms')},
        'synthetic': {k: count_syn[k] for k in (
            'ms', 'plain_ms', 'bound_ms', 'library_ms', 'bincount_ms',
            'plan', 'kernels_ms')}}]
    for k in kernels:
        # launches: the run of the kernel's own path (above), counted from
        # 0 just before it; beside it the 100,000-track uniform run and the
        # 10,000-track recorded run, each counted from 0 just before it
        k['launches_uniform_run'] = main_run[k['name']]
        k['launches_recorded_run'] = recorded[k['name']]
        # the multi-case paths (the direction sweep, the thermals run, the
        # drw run), the WTK modes (the seasonal run, the snapshot run with
        # its recounts), the cli, solver_options and notebooks phases, each
        # counted from 0 just before each run and summed over the phase
        new_paths = {'launches_sweep': sweep_run,
                     'launches_thermals_run': thermals_run,
                     'launches_drw_run': drw_run,
                     'launches_seasonal_run': seasonal_run,
                     'launches_snapshot_run': snapshot_run,
                     'launches_cli_run': cli_run,
                     'launches_solver_options': options_run,
                     'launches_notebooks_run': notebooks_run,
                     'launches_large_run': large_run}
        for key, counted in new_paths.items():
            k[key] = counted[k['name']]
            if k[key] < 1 and k['name'] in ('fused_chunk', 'presence_flush'):
                fail(f'{k["name"]}: not launched on its path ({key})')
        # the sharded phase's three driven runs, each counted from 0 just
        # before it: the Simulator on the mesh, simulate_presence_sharded,
        # the sweep's rerun with its cases over the mesh
        k['launches_sharded_run'] = sharded_run[k['name']]
        if k['launches_sharded_run'] < 1 and k['name'] in (
                'fused_chunk', 'presence_flush', 'fused_step'):
            fail(f'{k["name"]}: not launched on the sharded paths')
        if k['name'] == 'presence_histogram_batch' and \
                k['launches_snapshot_run'] < 1:
            fail('presence_histogram_batch: not launched by the snapshot '
                 "run's recounts")
        if k['name'] == 'presence_histogram_batch' and \
                k['launches_cli_run'] < 1:
            fail('presence_histogram_batch: not launched by the cli '
                 "phase's presence map from the .pkl")
        # the weighted histogram is a standalone kernel, as in ssrs_tpu:
        # no path runs it since the flush has its own kernel (phase_hist
        # holds it against its plain version all the same)
        if k['launches'] < 1 and k['name'] != 'presence_histogram':
            fail(f'{k["name"]}: not launched on its path')
    engine = {key: v for key, v in engine.items()
              if key not in ('per_step_path_launches', 'flush_real')}
    count = {key: hist[key] for key in ('count_hot_cell', 'count_bands',
                                        'count_sweep')}
    cases = {'no_table': no_table, 'thermals': thermals, 'sweep': sweep,
             'solver_options': options,
             'thermals_run': thermals_path, 'drw': drw,
             'seasonal': seasonal, 'snapshot': snapshot, 'cli': cli,
             'sharded': sharded, 'notebooks': notebooks, 'large': large}
    print(json.dumps({'solver': solver, 'engine': engine, 'count': count,
                      'cases': cases}), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
