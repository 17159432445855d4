"""The device trace of one job: torch.profiler over the job, read into
device busy time, kernel times by name, and idle gaps named by the
``Simulator`` phase the host was in.

The phases are marked from here: for the profiled job the program's
``PhaseTimer.phase`` is wrapped so that each phase is also a profiler
range (``phase:<name>``), and the whole job is the range ``job``. The
potential's preparation is no phase of its own: its idle time falls under
the phase around it, or under ``job``."""

from __future__ import annotations

import contextlib
import time

import torch

# a kernel's name in the breakdown: its first characters (a templated
# kernel's full name runs to hundreds)
NAME_CHARS = 120
# profiler event names of the CUDA runtime's kernel launches
LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaLaunchKernelExC',
            'cuLaunchKernelEx')


@contextlib.contextmanager
def phase_ranges():
    """Each ``PhaseTimer.phase`` of the program is also a profiler range
    while this is open."""
    from ssrs_tpu_torch.core import timing
    orig_phase = timing.PhaseTimer.phase

    @contextlib.contextmanager
    def phase(self, name, **meta):
        with torch.profiler.record_function(f'phase:{name}'):
            with orig_phase(self, name, **meta):
                yield

    timing.PhaseTimer.phase = phase
    try:
        yield
    finally:
        timing.PhaseTimer.phase = orig_phase


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile(fn):
    """Run ``fn()`` under the profiler. Returns (fn's result, a dict):
    ``window_s`` the job range's length, ``busy_s`` the union of device
    activity inside it, ``kernels`` {name: device seconds}, ``launches``,
    ``device_ops`` (the ten kernels of most device time, ``[name,
    seconds]``), ``idle_gaps`` (the device's idle time summed by the
    innermost range the host was in, the ten largest, ``[name,
    seconds]``), ``read_s`` the seconds spent reading the trace."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with phase_ranges(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function('job'):
            result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    window, phases, device, launches = None, [], [], 0
    kernels = {}
    cuda = torch.autograd.DeviceType.CUDA
    # the profiler's raw events: building its event tree (prof.events())
    # takes minutes for the ~10^6 events of a job's solve
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() * 1e-3
        end = start + ev.duration_ns() * 1e-3
        ranged = name == 'job' or name.startswith('phase:')
        if ev.device_type() == cuda:
            if ranged or ev.is_user_annotation():
                continue  # the ranges' copies on the device's timeline
            device.append((start, end))
            kernels[name] = kernels.get(name, 0.) + (end - start) * 1e-6
        elif name == 'job':
            window = (start, end)
        elif name.startswith('phase:'):
            phases.append((start, end, name[6:]))
        elif name in LAUNCHES:
            launches += 1
    busy = [(max(s, window[0]), min(e, window[1]))
            for s, e in _union(device) if e > window[0] and s < window[1]]
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    idle = {}  # idle seconds by the innermost range the host was in
    phases.sort()
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            mid = (s + e) / 2
            inside = [p for p in phases if p[0] <= mid <= p[1]]
            name = min(inside, key=lambda p: p[1] - p[0])[2] if inside \
                else 'job'
            idle[name] = idle.get(name, 0.) + (e - s) * 1e-6
    gaps = sorted(([k, v] for k, v in idle.items()), key=lambda g: -g[1])
    ops = sorted(([k[:NAME_CHARS], v] for k, v in kernels.items()),
                 key=lambda g: -g[1])
    return result, {
        'window_s': (window[1] - window[0]) * 1e-6,
        'busy_s': sum(e - s for s, e in busy) * 1e-6,
        'kernels': kernels, 'launches': launches,
        'device_ops': ops[:10], 'idle_gaps': gaps[:10],
        'read_s': time.perf_counter() - t0}
