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

Every phase prints one line; any failure exits non-zero. The last three
lines are a JSON object with the solver's, the track engine's, the
count's and the multi-case paths' numbers, one with the kernels' numbers
and the JSON status line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

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

    def kernel():
        return ph.presence_histogram(rb, cb, wb, NROW, NCOL)

    def plain():
        return ph.presence_histogram_plain(rb, cb, wb, NROW, NCOL)

    def library():
        return _index_put_map(torch, *lib_b, (NROW, NCOL))

    got, want, lib = kernel(), plain(), library()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err or int(want.sum()) <= 0 or not torch.equal(lib, want):
        fail(f'presence_histogram: differs from plain (max abs err {err}), '
             'or the library call does')
    tm = {'max_abs_err': err, 'ms': _device_ms(torch, kernel),
          'plain_ms': _device_ms(torch, plain),
          'library_ms': _device_ms(torch, library),
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
        f'{tm["library_ms"] * 1e3:.1f} us device; bound '
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
    weights = palive.to(torch.float32)
    work = base.clone()

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
        f'{tm["library_ms"] * 1e3:.1f} us device; bound '
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
    lib = _index_put_map(torch, r_in, c_in, ones, grid)
    got = {name: ph.presence_histogram_batch(rows, cols, nrow, ncol, plan=p)
           for name, p in [('plan', plan), *plans.items()]}
    torch.cuda.synchronize()
    err = max(int((g.long() - want.long()).abs().max()) for g in got.values())
    if err or not torch.equal(lib, want) or int(want.sum()) <= 0:
        fail(f'presence_histogram_batch ({what}): differs from plain (max '
             f'abs err {err}), or the library call does')
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
        f'{tm["library_ms"] * 1e3:.1f} us; bound {tm["bound_ms"] * 1e3:.2f} '
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
    uniform block), covering every step, and no per-step launch."""
    chunks = math.ceil(steps / DRIVER_CHUNK)
    if steps <= 0 or launched['fused_chunk'] != chunks or \
            launched['fused_chunk_steps'] != steps or launched['fused_step']:
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
    from ssrs_tpu_torch.agents.moves import (directional_probs,
                                             restriction_table)
    from ssrs_tpu_torch.agents.simulate import (
        init_state, make_step_fn, prepared_weights, simulate_presence,
        simulate_presence_compacting)
    from ssrs_tpu_torch.core.rng import case_generator
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
    starts = _run_starts(sim)
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


def phase_sweep(torch, device_name, out):
    """The direction sweep: SWEEP_DIRNS at the README region's width,
    100,000 tracks a direction, through ``simulate_direction_sweep``."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents.moves import directional_probs
    from ssrs_tpu_torch.agents.simulate import (
        prepared_weights, prepared_weights_batch,
        simulate_presence_cases_compacting, simulate_presence_compacting)
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

    # two cases against the single-case driver, bit for bit; every table
    # of the batched build against its own build
    params = sim._track_params()
    starts = _run_starts(cfg)
    dirp = torch.from_numpy(directional_probs(params.move_dirn)).to(dev)
    ups = torch.stack([sim.load_updrafts(c)[0] for c in cases])
    potentials = torch.stack([torch.from_numpy(load(c, 'potential')).to(dev)
                              for c in cases])
    tables = prepared_weights_batch(ups, potentials, dirp.expand(n_cases, 9),
                                    params.weight_dtype)
    for i in range(n_cases):
        single = prepared_weights(ups[i], potentials[i], dirp,
                                  params.weight_dtype)
        if not torch.equal(tables[i].view(torch.int16),
                           single.view(torch.int16)):
            fail(f'sweep: table {i} of the batched build differs from its '
                 'own build')
    # the first case, and one whose potential came from the fallback (or
    # 225 degrees, where the refined solve stalled on the tests' field)
    fallen = [i for i, r in enumerate(pots) if r['fallback'] and i > 0]
    picks = [0, (fallen + [n_cases // 2 + 1])[0]]
    for i in picks:
        got, steps = simulate_presence_compacting(
            params, starts, case_generator(cfg.sim_seed, cases[i], 0,
                                           'tracks', dev),
            base_flat=tables[i], dirp=dirp)
        if steps != rec['steps'][i] or \
                not np.array_equal(got.cpu().numpy(), counts[cases[i]]):
            fail(f'sweep: case {cases[i]} differs from the single-case '
                 'compacting driver')
    say(f'sweep: cases {[cases[i] for i in picks]} bit-identical to '
        'simulate_presence_compacting with the same seed, table and '
        f'starts; the {n_cases} batched tables equal their own builds')

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

    name = phase_device(torch)
    phase_build()
    max_err, timing = phase_kernel(torch)
    chunk_err = phase_chunk(torch)
    no_table = phase_no_table(torch)
    hist = phase_hist(torch)
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        main_run, sim = phase_main(torch, name, out)
        solver = phase_solver(torch, sim, name)
        engine = phase_chunk_main(torch, sim, name)
        recorded, count_real = phase_recorded(torch, name, out)
        thermals = phase_thermals(torch, sim)
        sweep_run, sweep = phase_sweep(torch, name, out)
        thermals_run, thermals_path = phase_thermals_run(torch, name, out)
        drw_run, drw = phase_drw(torch, name, out)
    phase_small(torch)
    if any(m for m in sys.modules if m.split('.')[0] in ('jax', 'ssrs_tpu')):
        fail('JAX or ssrs_tpu was imported')
    bf16, f32 = timing['bfloat16'], timing['float32']
    flush_real, flush_syn = engine['flush_real'], hist['presence_flush']
    count_syn = hist['presence_histogram_batch']
    kernels = [{
        'name': 'fused_step', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/fused_step.cu',
        'replaces': 'ssrs_tpu/agents/fused_step.py:52',
        # its path: the per-step driver simulate_presence
        'path': 'simulate_presence',
        'launches': engine['per_step_path_launches']['fused_step'],
        'max_abs_err': max(max_err, no_table['max_abs_err']),
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
        'max_abs_err': max(chunk_err, no_table['max_abs_err']),
        'ms': engine['chunk_ms'],
        'plain_ms': engine['plain_ms'], 'bound_ms': engine['bound_ms'],
        'bound_by': engine['bound_by'], 'library_ms': None,
        'steps': CHUNK_T, 'per_step_ms': engine['per_step_device_ms'],
        'uniform_draw_ms': engine['uniform_draw_ms'],
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
                           flush_syn['max_abs_err']),
        'ms': flush_real['ms'], 'plain_ms': flush_real['plain_ms'],
        'bound_ms': flush_real['bound_ms'],
        'bound_by': flush_real['bound_by'],
        'library_ms': flush_real['library_ms'],
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
            'library_ms')}}, {
        # times on the recorded run's own .pkl points; beside them the
        # 6.4M synthetic points, each kernel in turns
        'name': 'presence_histogram_batch', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/presence_hist.cu',
        'replaces': 'ssrs_tpu/agents/pallas_hist.py:59',
        'path': "get_presence_counts' .pkl fallback",
        'launches': recorded['presence_histogram_batch'],
        'max_abs_err': max(count_real['max_abs_err'],
                           count_syn['max_abs_err']),
        **{k: count_real[k] for k in (
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'plan',
            'kernels_ms', 'host_ms')},
        'synthetic': {k: count_syn[k] for k in (
            'ms', 'plain_ms', 'bound_ms', 'library_ms', 'plan',
            'kernels_ms')}}]
    for k in kernels:
        # launches: the run of the kernel's own path (above), counted from
        # 0 just before it; beside it the 100,000-track uniform run and the
        # 10,000-track recorded run, each counted from 0 just before it
        k['launches_uniform_run'] = main_run[k['name']]
        k['launches_recorded_run'] = recorded[k['name']]
        # this slice's paths: the direction sweep, the thermals run and the
        # drw run, each counted from 0 just before it
        new_paths = {'launches_sweep': sweep_run,
                     'launches_thermals_run': thermals_run,
                     'launches_drw_run': drw_run}
        for key, counted in new_paths.items():
            k[key] = counted[k['name']]
            if k[key] < 1 and k['name'] in ('fused_chunk', 'presence_flush'):
                fail(f'{k["name"]}: not launched on its path ({key})')
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
             'thermals_run': thermals_path, 'drw': drw}
    print(json.dumps({'solver': solver, 'engine': engine, 'count': count,
                      'cases': cases}), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
