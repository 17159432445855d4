#!/usr/bin/env python3
"""Smoke test of ssrs_tpu_torch on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (the
fused agent step, and the presence histograms: weighted for the flush,
counting for the recount of recorded tracks), holds each against its
plain PyTorch version on the card at the shapes its path gives it, and
drives two runs of the README's region (500x600 cells at 100 m): the
uniform-mode run of 100,000 tracks with the default potential solver
(the refined solver, on the card), and the recorded-track run of 10,000
tracks (the default track_pkl_budget) on the cached potential, which
writes ``_tracks.pkl`` and must agree exactly with its own recount. It
holds the main run's potential to the invariants of the reference's
system, solves it twice more on the card (bitwise equal, one solve
profiled), beside the host direct solve, and solves the 460x460 hard
field of tests/test_potential.py against the direct solve. It checks
small runs on the card, with and without recorded tracks, against the
same runs through the plain versions on the CPU. Every phase prints one
line; any failure exits non-zero. The last three lines are a JSON object
with the solver's numbers, one with the kernels' numbers and the JSON
status line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
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
# kernel B at the flush of the main path's first compaction; kernel C at
# the recorded run's mass (10,000 tracks of ~630 moves)
HIST_B_POINTS = 100_000
HIST_C_POINTS = 6_400_000
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
    that the runs below time no build."""
    from ssrs_tpu_torch import _build, native
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_info['log'].splitlines()
            if 'registers' in ln]
    say(f'build: {secs:.2f} s (nvcc {_build.build_info["seconds"]:.2f} s) '
        f'{_build.build_info["path"]}; ptxas: {" | ".join(regs)}')
    t0 = time.perf_counter()
    if not native.native_available():
        fail('the C++ track builder does not build (g++)')
    say(f'build: C++ track builder {time.perf_counter() - t0:.2f} s')


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
        say(f'timing {dname} N={N_AGENTS}: kernel {tm["ms"] * 1e3:.1f} us '
            f'device / {tm["host_ms"] * 1e3:.1f} us wall per step; plain '
            f'{tm["plain_ms"] * 1e3:.1f} us device / '
            f'{tm["plain_host_ms"] * 1e3:.1f} us wall per step')
    return max_err, timing


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
    """Kernels B and C against their plain versions on the card at their
    paths' shapes (exact), and their times."""
    from ssrs_tpu_torch.agents import presence_hist as ph
    dev = torch.device('cuda')
    rng = np.random.default_rng(2027)
    r, c = _scatter_indices(rng, HIST_B_POINTS)
    rb = torch.from_numpy(r.astype(np.int32)).to(dev)
    cb = torch.from_numpy(c.astype(np.int32)).to(dev)
    wb = torch.from_numpy(
        (rng.random(HIST_B_POINTS) < 0.6).astype(np.float32)).to(dev)
    r, c = _scatter_indices(rng, HIST_C_POINTS)
    r[rng.random(HIST_C_POINTS) < 0.3] = -1
    rc = torch.from_numpy(r.astype(np.int16)).to(dev)
    cc = torch.from_numpy(c.astype(np.int16)).to(dev)
    cases = {
        'presence_histogram': (
            lambda: ph.presence_histogram(rb, cb, wb, NROW, NCOL),
            lambda: ph.presence_histogram_plain(rb, cb, wb, NROW, NCOL),
            f'N={HIST_B_POINTS} 0/1 weights'),
        'presence_histogram_batch': (
            lambda: ph.presence_histogram_batch(rc, cc, NROW, NCOL),
            lambda: ph.presence_histogram_batch_plain(rc, cc, NROW, NCOL),
            f'M={HIST_C_POINTS} int16, 30% dead'),
    }
    out = {}
    for name, (kernel, plain, what) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err or int(want.sum()) <= 0:
            fail(f'{name}: differs from plain (max abs err {err})')
        tm = {'max_abs_err': err,
              'ms': _device_ms(torch, kernel),
              'plain_ms': _device_ms(torch, plain),
              'host_ms': _host_ms(torch, kernel),
              'plain_host_ms': _host_ms(torch, plain)}
        out[name] = tm
        say(f'{name} ({what}, {NROW}x{NCOL}): exact match with plain; '
            f'kernel {tm["ms"] * 1e3:.1f} us device / '
            f'{tm["host_ms"] * 1e3:.1f} us wall; plain '
            f'{tm["plain_ms"] * 1e3:.1f} us device / '
            f'{tm["plain_host_ms"] * 1e3:.1f} us wall')
    return out


def _reset_counts():
    from ssrs_tpu_torch.agents import fused_step, presence_hist, simulate
    fused_step.reset_launch_count()
    presence_hist.reset_launch_count()
    simulate.reset_flush_count()


def _read_counts():
    from ssrs_tpu_torch.agents import fused_step, presence_hist, simulate
    return {'fused_step': fused_step.launch_count(),
            'presence_histogram':
                presence_hist.launch_count('presence_histogram'),
            'presence_histogram_batch':
                presence_hist.launch_count('presence_histogram_batch'),
            'flushes': simulate.flush_count()}


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
    if launched['fused_step'] != steps or steps <= 0:
        fail(f'main path: {launched["fused_step"]} kernel launches for '
             f'{steps} steps')
    if launched['presence_histogram'] != launched['flushes'] or \
            launched['flushes'] < 1:
        fail(f'main path: {launched["presence_histogram"]} histogram '
             f'launches for {launched["flushes"]} flushes')
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
    say(f'main path: {steps} steps, {launched["fused_step"]} kernel '
        f'launches, {launched["flushes"]} flushes through '
        f'{launched["presence_histogram"]} histogram launches, {useful} '
        f'agent-steps in {tracks_s:.3f} s = {useful / tracks_s:.4g} '
        f'agent-steps/s on {device_name}')
    return launched, sim


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
    from ssrs_tpu_torch.agents import get_starting_indices
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
    if launched['fused_step'] != steps or steps <= 0:
        fail(f'recorded run: {launched["fused_step"]} step launches for '
             f'{steps} steps')
    if launched['presence_histogram'] != launched['flushes'] or \
            launched['flushes'] < 1:
        fail(f'recorded run: {launched["presence_histogram"]} histogram '
             f'launches for {launched["flushes"]} flushes')
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
    rows, cols = get_starting_indices(
        cfg.track_count, list(cfg.track_start_region), cfg.track_start_type,
        tuple(cfg.region_width_km), float(cfg.resolution),
        rng=np.random.default_rng(cfg.sim_seed))
    lengths = _check_tracks(tracks, np.stack([rows, cols], axis=1),
                            NROW, NCOL, sim.grid.burnin_length(),
                            cfg.track_max_steps)
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
            recounted['fused_step'] or recounted['presence_histogram']:
        fail(f'recorded run: the pkl fallback launched {recounted}, not '
             'the count kernel once')
    launched['presence_histogram_batch'] = \
        recounted['presence_histogram_batch']
    # the int32 recount of the .pkl through kernel C, cell for cell (after
    # the counts are read: this launch is the smoke's, not the path's)
    pts = torch.from_numpy(np.ascontiguousarray(
        np.concatenate(tracks).T)).to(sim.device)
    recount = presence_histogram_batch(pts[0], pts[1], NROW, NCOL)
    if not np.array_equal(recount.cpu().numpy(), counts):
        fail('recorded run: _counts.npy differs from the recount of the pkl')
    if fallback.dtype != np.int16 or \
            not np.array_equal(fallback, counts.astype(np.int16)):
        fail('recorded run: get_presence_counts without _counts.npy is not '
             'the int16 recount')
    useful = rec['useful_steps']
    say(f'recorded run: {cfg.track_count} tracks, {steps} steps, '
        f'{launched["flushes"]} flushes, {useful} agent-steps in '
        f'{rec["seconds"]:.3f} s = {useful / rec["seconds"]:.4g} '
        f'agent-steps/s on {device_name}; track rebuild '
        f'{rec["build_seconds"]:.3f} s (C++), .pkl write '
        f'{records["write_tracks"]["seconds"]:.3f} s; exact: tracks, '
        'counts = recount, int16 fallback')
    return launched


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
    hist = phase_hist(torch)
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        main_run, sim = phase_main(torch, name, out)
        solver = phase_solver(torch, sim, name)
        recorded = phase_recorded(torch, name, out)
    phase_small(torch)
    if any(m for m in sys.modules if m.split('.')[0] in ('jax', 'ssrs_tpu')):
        fail('JAX or ssrs_tpu was imported')
    bf16, f32 = timing['bfloat16'], timing['float32']
    kernels = [{
        'name': 'fused_step', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/fused_step.cu',
        'replaces': 'ssrs_tpu/agents/fused_step.py:52',
        'max_abs_err': max_err, 'ms': bf16['ms'],
        'plain_ms': bf16['plain_ms'], 'ms_float32': f32['ms'],
        'plain_ms_float32': f32['plain_ms']}]
    for name_k, line in (('presence_histogram', 31),
                         ('presence_histogram_batch', 59)):
        tm = hist[name_k]
        kernels.append({
            'name': name_k, 'route': 'cuda',
            'source': 'ssrs_tpu_torch/csrc/presence_hist.cu',
            'replaces': f'ssrs_tpu/agents/pallas_hist.py:{line}',
            'max_abs_err': tm['max_abs_err'], 'ms': tm['ms'],
            'plain_ms': tm['plain_ms']})
    for k in kernels:
        # launches: the recorded-track run (A and B) and its pkl fallback
        # (C), each counted from 0 just before it; launches_uniform_run:
        # the 100,000-track run (A and B)
        k['launches'] = recorded[k['name']]
        k['launches_uniform_run'] = main_run[k['name']]
    print(json.dumps({'solver': solver}), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
