"""Agents sharded over several devices.

The PyTorch counterpart of ``ssrs_tpu/parallel/mesh.py``. The JAX package
is single-controller: one process drives every local device through
``shard_map``, with the agent batch split into contiguous blocks over a
1-D mesh, the weight table replicated and one ``psum`` of the presence
maps at the end. The port's drivers are host loops already, so here a
shard is one more population that the host loop feeds, on its own device:

- a mesh is a tuple of ``torch.device``s (:func:`make_mesh`). It may repeat
  a device: that is how one card, or the CPU, runs several shards;
- shard i takes the i-th contiguous block of the padded starts and draws
  from a ``torch.Generator`` on its device seeded with
  ``core.rng.fold_in(seed, i)``, the counterpart of
  ``jax.random.fold_in(key, axis_index)``: deterministic for a fixed mesh
  size;
- the weight table is built once, on ``mesh[0]``, and copied once to each
  other device;
- the only traffic between devices is one sum of the shards' int32 maps
  onto ``mesh[0]`` at the end, exact in any order.

One process and no ``torch.distributed``: a process group would make the
``Simulator`` a multi-process program, which the JAX package is not, and
the one sum at the end is a copy between devices, not a collective.

One deliberate difference from the JAX package: its compacting driver
shrinks all shards to one bucket in lockstep, sized by a ``pmax`` of their
alive counts, because SPMD needs one static shape on every shard. The
host loop has no such constraint, so each shard keeps its own bucket
ladder, and shard i's map is bit-identical to
``simulate_presence_compacting`` on its starts and flags with a generator
seeded by ``fold_in(seed, i)``. Against the JAX package the maps agree
statistically; their random streams differ anyway.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..agents.presence import card_or_raise
from ..agents.simulate import (TrackParams, _place_cases, _prologue,
                               field_table, flush_pending,
                               simulate_presence_cases_compacting)
from ..core.rng import fold_in


def make_mesh(n_devices: int = 0, devices=None) -> Tuple[torch.device, ...]:
    """The devices of a 1-D mesh: ``devices`` (by default every visible
    CUDA device, the counterpart of ``jax.devices()``), the first
    ``n_devices`` of them when ``n_devices`` > 0. The list may repeat a
    device. A CUDA device raises when there is no card."""
    if devices is None:
        card_or_raise('cuda', 'make_mesh')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    mesh = tuple(card_or_raise(d, 'make_mesh') for d in devices)
    if n_devices and n_devices > 0:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError('make_mesh: no device')
    return mesh


def pad_to_multiple(starts: np.ndarray, multiple: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the agent batch so it divides evenly across devices; padding
    agents are marked invalid (they start dead and contribute nothing)."""
    n = starts.shape[0]
    n_pad = (-n) % multiple
    valid = np.ones(n + n_pad, dtype=bool)
    if n_pad:
        starts = np.concatenate(
            [starts, np.broadcast_to(starts[-1:], (n_pad, 2))], axis=0)
        valid[n:] = False
    return np.ascontiguousarray(starts), valid


def _shard_generators(seed: int, mesh: Sequence[torch.device]):
    """One generator a shard: shard i's on ``mesh[i]``, seeded with
    ``fold_in(seed, i)``."""
    gens = []
    for i, dev in enumerate(mesh):
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_in(seed, i))
        gens.append(gen)
    return gens


def _blocks(x, n: int):
    """``x`` (numpy or a tensor) cut into ``n`` contiguous equal blocks
    along its first axis."""
    if len(x) % n:
        raise ValueError(f'{len(x)} agents do not split over {n} shards; '
                         'pad them first (pad_to_multiple)')
    per = len(x) // n
    return [x[i * per:(i + 1) * per] for i in range(n)]


def _check_fields(has_updraft: bool, has_potential: bool) -> None:
    if has_potential and not has_updraft:
        raise ValueError('potential requires updraft (the fluidflow '
                         'weight table is built from both)')


def sharded_presence_fn(params: TrackParams, mesh: Sequence[torch.device],
                        chunk: int = 128, has_updraft: bool = True,
                        has_potential: bool = True):
    """The sharded non-compacting simulation as a callable over ``mesh``.

    The returned function takes ``(starts, valid, seed[, updraft
    [, potential]])``, with as many agents as a multiple of the mesh size
    (:func:`pad_to_multiple`), and returns ``(presence int32 (nrow, ncol)
    on mesh[0], steps)``, the steps being the most any shard took. Shard
    i runs ``simulate_presence`` on its block with a generator seeded by
    ``fold_in(seed, i)`` (the per-step kernel on the card); the shards are
    interleaved, one chunk of ``chunk`` steps each a round, before any
    alive count of the round is read."""
    _check_fields(has_updraft, has_potential)
    mesh = tuple(mesh)

    def run(starts, valid, seed: int, *fields):
        updraft = fields[0] if has_updraft else None
        potential = fields[int(has_updraft)] if has_potential else None
        n_dev = len(mesh)
        gens = _shard_generators(seed, mesh)
        tables = _place_cases(
            [field_table(params, updraft, potential, mesh[0])] * n_dev,
            gens, mesh)
        states, steps = [], []
        for st, va, gen, table in zip(_blocks(starts, n_dev),
                                      _blocks(valid, n_dev), gens, tables):
            state, step = _prologue(params, st, gen, None, None, va, table,
                                    None, chunked=False)
            states.append(state)
            steps.append(step)
        active = [i for i in range(n_dev)
                  if params.nsteps > 0 and states[i].pos_r.shape[0] > 0]
        while active:
            counts = {}
            for i in active:
                for _ in range(min(chunk, params.nsteps - states[i].step)):
                    states[i] = steps[i](states[i], generator=gens[i])
                counts[i] = states[i].alive.sum()
            active = [i for i in active if states[i].step < params.nsteps
                      and int(counts[i]) > 0]
        maps = [flush_pending(s).presence.to(mesh[0]) for s in states]
        return (torch.stack(maps).sum(0, dtype=torch.int32),
                max(s.step for s in states))

    return run


def simulate_presence_sharded(params: TrackParams, start_rc, seed: int,
                              updraft=None, potential=None,
                              mesh: Optional[Sequence[torch.device]] = None,
                              chunk: int = 128):
    """Run the non-compacting simulation with agents sharded over the mesh
    (default: every visible card).

    Returns (presence int32 (nrow, ncol) on mesh[0], globally summed,
    steps)."""
    mesh = make_mesh() if mesh is None else tuple(mesh)
    starts, valid = pad_to_multiple(np.asarray(start_rc, np.int32),
                                    len(mesh))
    fields = [f for f in (updraft, potential) if f is not None]
    return sharded_presence_fn(
        params, mesh, chunk, has_updraft=updraft is not None,
        has_potential=potential is not None)(starts, valid, seed, *fields)


def simulate_presence_sharded_compacting(
        params: TrackParams, start_rc, seed: int, updraft=None,
        potential=None, mesh: Optional[Sequence[torch.device]] = None,
        chunk: int = 512, min_bucket: int = 1024, tail_bucket=0):
    """Sharded presence simulation with dead-agent compaction: each shard
    runs the single-device compacting pipeline (the chunk kernel, the
    bucket ladder, the flush before each compaction) on its own device,
    the shards interleaved round-robin by
    ``simulate_presence_cases_compacting``, with the table built once and
    copied to each distinct device. ``tail_bucket`` as in
    ``simulate_presence_cases_compacting``: with ``'auto'`` each shard
    stops compacting on its own, where the measured rule says (the JAX
    package's sharded driver takes ``'auto'`` as ``min_bucket``, since its
    shards share one bucket).

    Returns (presence int32 (nrow, ncol) on mesh[0], globally summed,
    steps: the most any shard took)."""
    maps, steps = shard_maps_compacting(
        params, start_rc, seed, updraft, potential, mesh, chunk, min_bucket,
        tail_bucket)
    return maps.sum(0, dtype=torch.int32), int(steps.max())


def shard_maps_compacting(params: TrackParams, start_rc, seed: int,
                          updraft=None, potential=None, mesh=None,
                          chunk: int = 512, min_bucket: int = 1024,
                          tail_bucket=0):
    """:func:`simulate_presence_sharded_compacting` before its sum: the
    shards' own maps, int32 (shards, nrow, ncol) gathered onto mesh[0],
    and their steps, int32 (shards,) numpy."""
    _check_fields(updraft is not None, potential is not None)
    mesh = make_mesh() if mesh is None else tuple(mesh)
    n_dev = len(mesh)
    starts, valid = pad_to_multiple(np.asarray(start_rc, np.int32), n_dev)
    gens = _shard_generators(seed, mesh)
    table = field_table(params, updraft, potential, mesh[0])
    return simulate_presence_cases_compacting(
        params, [table] * n_dev, _blocks(starts, n_dev), gens, chunk=chunk,
        min_bucket=min_bucket, tail_bucket=tail_bucket,
        valid=_blocks(valid, n_dev), devices=mesh)
