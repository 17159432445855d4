#!/usr/bin/env python3
"""Smoke test of ssrs_tpu_torch on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds
it against its plain PyTorch version on the card at the main path's
shapes, drives the main path once (the README's uniform-mode run:
500x600 cells at 100 m, 100,000 tracks, with the direct potential
solve), checks the results, and checks a small run on the card against
the same run through the plain versions on the CPU. Every phase prints
one line; any failure exits non-zero. The last two lines are a JSON
object with the kernel's numbers and the JSON status line
``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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
    potential_solver='direct', track_max_steps=10_000, sim_seed=7)
# a small run (the tests' WY config) compared between card and CPU
SMALL_CONFIG = dict(
    run_name='wy_small', sim_mode='uniform', sim_seed=11,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(12., 10.),
    resolution=200., uniform_winddirn=270., uniform_windspeed=10.,
    track_direction=0., track_count=4096, track_start_region=(1., 11., 1., 2.),
    track_start_type='random', track_max_steps=400,
    potential_solver='direct', track_pkl_budget=0, mesh_devices=1)
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
    from ssrs_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_info['log'].splitlines()
            if 'registers' in ln]
    say(f'build: {secs:.2f} s (nvcc {_build.build_info["seconds"]:.2f} s) '
        f'{_build.build_info["path"]}; ptxas: {" | ".join(regs)}')


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


def phase_main(torch, device_name):
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents import launch_count, reset_launch_count
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        cfg = Config(out_dir=out, **MAIN_CONFIG)
        t0 = time.perf_counter()
        sim = Simulator(cfg)
        ctor = time.perf_counter() - t0
        reset_launch_count()
        sim.simulate_tracks()
        launches = launch_count()
        sim.compute_presence_map()
        records = {r['phase']: r for r in sim.timer.records}
        steps = records['tracks']['steps']
        if launches != steps or steps <= 0:
            fail(f'main path: {launches} kernel launches for {steps} steps')
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
        say(f'main path: {steps} steps, {launches} kernel launches, '
            f'{useful} agent-steps in {tracks_s:.3f} s = '
            f'{useful / tracks_s:.4g} agent-steps/s on {device_name}')
    return launches


def phase_small(torch):
    """The small WY run on the card and through the plain versions on
    the CPU, on one potential: the CPU run reads the card run's cached
    potential from the shared out_dir (where the conductivity is high the
    potential is flat to float32 ulps, so two potentials that differ by
    ulps alone move the maps apart by more than sampling noise)."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents import smooth_presence
    maps = []
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        for device in ('cuda', 'cpu'):
            sim = Simulator(Config(out_dir=out, **SMALL_CONFIG),
                            device=device)
            sim.simulate_tracks()
            counts = sim.get_presence_counts(sim.case_ids[0], 0)
            smooth = smooth_presence(torch.from_numpy(counts), 3).numpy()
            maps.append(smooth.astype(np.float64) / smooth.sum())
    l1 = float(np.abs(maps[0] - maps[1]).sum())
    if not l1 < L1_BOUND:
        fail(f'small run: card vs CPU L1 {l1:.4f} >= {L1_BOUND}')
    say(f'small run: card vs CPU plain versions L1 {l1:.4f} < {L1_BOUND}')


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
    launches = phase_main(torch, name)
    phase_small(torch)
    if any(m for m in sys.modules if m.split('.')[0] in ('jax', 'ssrs_tpu')):
        fail('JAX or ssrs_tpu was imported')
    bf16, f32 = timing['bfloat16'], timing['float32']
    print(json.dumps({'kernels': [{
        'name': 'fused_step', 'route': 'cuda',
        'source': 'ssrs_tpu_torch/csrc/fused_step.cu',
        'replaces': 'ssrs_tpu/agents/fused_step.py:52',
        'launches': launches, 'max_abs_err': max_err,
        'ms': bf16['ms'], 'plain_ms': bf16['plain_ms'],
        'ms_float32': f32['ms'], 'plain_ms_float32': f32['plain_ms']}]}),
        flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
