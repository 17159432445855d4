"""The device trace of one job: torch.profiler over the job, read into
device busy time, kernel times by name, and idle gaps named by the
``Simulator`` span the host was in.

The program opens the profiler range ``phase:<name>`` of each of its
spans itself while a profiler is on; the whole job is the range ``job``,
opened here. Idle time under no span falls under ``job``."""

from __future__ import annotations

import heapq
import time

import torch

# a kernel's name in the breakdown: its first characters (a templated
# kernel's full name runs to hundreds)
NAME_CHARS = 120
# profiler event names of the CUDA runtime's kernel launches
LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaLaunchKernelExC',
            'cuLaunchKernelEx')


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def innermost(phases, points) -> list:
    """The name of the shortest of ``phases`` (sorted ``(start, end,
    name)``, closed intervals) that holds each of ``points`` (ascending),
    the first in order among equally long ones, or ``'job'`` where none
    does: one sweep with a heap of the ranges begun, by length."""
    heap, names, k = [], [], 0
    for x in points:
        while k < len(phases) and phases[k][0] <= x:
            s, e, name = phases[k]
            heapq.heappush(heap, (e - s, k, e, name))
            k += 1
        while heap and heap[0][2] < x:
            heapq.heappop(heap)
        names.append(heap[0][3] if heap else 'job')
    return names


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
    with torch.profiler.profile(activities=acts) as prof:
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
    gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    idle = {}  # idle seconds by the innermost range the host was in
    for (s, e), name in zip(gaps, innermost(
            sorted(phases), [(s + e) / 2 for s, e in gaps])):
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
