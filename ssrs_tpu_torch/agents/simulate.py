"""The agent simulation core: all tracks advance in lockstep.

The PyTorch counterpart of ``ssrs_tpu/agents/simulate.py``, for the
parts the uniform-mode run uses: the compacting driver, the recording
driver that rebuilds every trajectory, and the non-compacting
``simulate_presence``. The reference simulates each track
with a sequential Python loop in a process pool (ssrs/movmodel.py:264-318);
here the whole population advances in lockstep: the compacting and the
recording drivers run a chunk of steps per launch of the chunk kernel
(``agents/fused_chunk.py``), ``simulate_presence`` and direction
memories longer than the chunk kernel takes one step per launch of the
fused step kernel (``agents/fused_step.py``):

- per-cell move weights (harmonic-mean updraft lift x potential drop x
  inverse distance, ssrs/movmodel.py:294-305) depend only on the cell, so
  they are precomputed once into a flat ``(nrow*ncol, 9)`` table that the
  kernel gathers from;
- the direction-memory restriction is a ring buffer of the last K move
  indices, AND-ing rows of the (9, 9) restriction table
  (ssrs/movmodel.py:307-309);
- moves are sampled by inverse-CDF with one uniform per agent-step from a
  ``torch.Generator`` (a chunk draws its uniforms as one block);
- burn-in boundary pushes and boundary absorption are masks
  (ssrs/movmodel.py:276,285-291,205-217);
- presence counts accumulate on the device in an int32 (nrow, ncol) map.

Presence accumulation is DELAYED BY ONE STEP, as in the JAX package: step
t counts the *carried* position with the previous step's alive flag
(``palive``), and :func:`flush_pending` adds the pending positions, through
the flush kernel (``agents/presence_hist.py``), before every compaction
and at the end. The counted multiset of (position, alive)
pairs equals counting each new position at once.

The step counter ``SimState.step`` is a host integer: the compacting loop
knows how many steps it launched, so the burn-in and cap decisions need no
device read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..native import make_builder
from .fused_chunk import MAX_MEMORY_K, fused_chunk
from .fused_step import alive_and_push, fused_step
from .moves import (CENTER_ZERO, NEIGHBOR_DELTAS, NEIGHBOR_NORMS_INV,
                    directional_probs, restriction_table)
from .presence_hist import presence_flush


class TrackParams(NamedTuple):
    """Static per-run parameters of the movement model."""
    grid_shape: Tuple[int, int]        # (nrow, ncol)
    move_dirn: float                   # degrees cw from north
    nu: float                          # sharpening exponent
    memory_k: int                      # direction-memory length (>= 0)
    burnin: int                        # boundary-push steps
    nsteps: int                        # step cap
    # storage dtype of the per-cell move-weight table: 'auto'
    # (resolve_weight_dtype), 'float32' or 'bfloat16' (~0.4% relative
    # weight quantization)
    weight_dtype: str = 'auto'


# 'auto' weight-table rule: float32 while the float32 table is at most
# this many bytes, bfloat16 above. The threshold is the JAX package's
# (a TPU on-chip memory budget, ssrs_tpu/agents/simulate.py), kept as it
# is so that both packages build the same table for the same config. It
# has not been measured on the H100 yet (ROADMAP.md).
AUTO_F32_MAX_BYTES = 6 * 2 ** 20

_AUTO_DTYPE_NOTICED: set = set()

_TORCH_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def resolve_weight_dtype(dtype: str, grid_shape) -> str:
    """Resolve the 'auto' weight-storage tier; explicit 'float32' and
    'bfloat16' pass through."""
    if dtype != 'auto':
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"weight dtype {dtype!r}: expected 'auto', "
                             "'float32' or 'bfloat16'")
        return dtype
    nrow, ncol = int(grid_shape[0]), int(grid_shape[1])
    f32_bytes = nrow * ncol * 9 * 4
    if f32_bytes <= AUTO_F32_MAX_BYTES:
        return 'float32'
    if (nrow, ncol) not in _AUTO_DTYPE_NOTICED:
        _AUTO_DTYPE_NOTICED.add((nrow, ncol))
        print(f'ssrs_tpu_torch: weight table at {nrow}x{ncol} is '
              f'{f32_bytes / 2**20:.1f} MB in float32, above the '
              f'{AUTO_F32_MAX_BYTES / 2**20:.0f} MB auto limit; storing '
              "bfloat16. Set track_weight_precision='float32' to force "
              'full precision.', flush=True)
    return 'bfloat16'


def harmonic_mean_weights(updraft: torch.Tensor,
                          potential: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-cell move weights ``(..., nrow, ncol, 9)`` in float32, of one
    ``(nrow, ncol)`` field pair or of a stack of them.

    base[r, c, m] = hm(w[r, c], w[r+dr, c+dc])
                    * [(p[r, c] - p[r+dr, c+dc]) / ||d||  if potential given]

    matching the 3x3 patch math at ssrs/movmodel.py:294-305 (updraft
    clipped to >= 1e-6 first; the potential is padded with NaN, so border
    cells get NaN weights, which prepared_weights replaces).
    """
    w = torch.clamp(updraft.to(torch.float32), min=1e-6)
    nrow, ncol = w.shape[-2:]
    wpad = F.pad(w, (1, 1, 1, 1), value=1e-6)
    if potential is not None:
        p = potential.to(device=w.device, dtype=torch.float32)
        ppad = F.pad(p, (1, 1, 1, 1), value=float('nan'))
    layers = []
    for m in range(9):
        dr, dc = int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1])
        wn = wpad[..., dr + 1:dr + 1 + nrow, dc + 1:dc + 1 + ncol]
        hm = 2.0 / (1.0 / w + 1.0 / wn)
        if potential is not None:
            pn = ppad[..., dr + 1:dr + 1 + nrow, dc + 1:dc + 1 + ncol]
            hm = hm * (p - pn) * float(NEIGHBOR_NORMS_INV[m])
        elif m == 4:
            hm = torch.zeros_like(hm)
        layers.append(hm)
    return torch.stack(layers, dim=-1)


def prepared_weights(updraft: torch.Tensor,
                     potential: Optional[torch.Tensor],
                     dirp: torch.Tensor, dtype: str) -> torch.Tensor:
    """Move-weight table with the per-agent cascade prologue folded in.

    The first three operations of ``generate_move_probabilities``
    (ssrs/movmodel.py:227-232) — replace-with-directional-prior on NaN,
    clip to >= 0, zero the center — depend only on the cell, so they are
    applied once here. Returns the contiguous flat (nrow*ncol, 9) table in
    the storage dtype that :func:`resolve_weight_dtype` picks
    (``.to(torch.bfloat16)`` rounds to nearest even, as XLA does).
    """
    dtype = resolve_weight_dtype(dtype, updraft.shape)
    return _prepared_weights_body(updraft, potential, dirp, dtype)


def _prepared_weights_body(updraft, potential, dirp, dtype: str):
    """The table(s) of ``(..., nrow, ncol)`` fields and ``(..., 9)``
    priors, ``(..., nrow*ncol, 9)`` in the resolved ``dtype``: elementwise
    over the leading axes, so a stack gives each case the bits of its own
    call."""
    base = harmonic_mean_weights(updraft, potential)
    center0 = torch.from_numpy(CENTER_ZERO).to(base.device)
    base = torch.clamp(base, min=0.) * center0
    row_nan = torch.isnan(base).any(dim=-1, keepdim=True)
    prior = (dirp.to(base.device) * center0)[..., None, None, :]
    base = torch.where(row_nan, prior, base)
    return base.reshape(*base.shape[:-3], -1, 9).to(
        _TORCH_DTYPES[dtype]).contiguous()


def prepared_weights_batch(updrafts: torch.Tensor, potentials: torch.Tensor,
                           dirps: torch.Tensor, dtype: str) -> torch.Tensor:
    """All C cases' weight tables at once: ``(C, nrow, ncol)`` updrafts
    and potentials and ``(C, 9)`` priors give the ``(C, nrow*ncol, 9)``
    tables, each equal bit for bit to its own :func:`prepared_weights`
    call."""
    dtype = resolve_weight_dtype(dtype, updrafts.shape[1:])
    return _prepared_weights_body(updrafts, potentials, dirps, dtype)


def weights_from_numpy(table: np.ndarray, device) -> torch.Tensor:
    """A flat ``(nrow*ncol, 9)`` weight table held as numpy (float32, or
    the ``bfloat16`` dtype JAX arrays convert to) as a tensor on
    ``device``, bit for bit."""
    table = np.array(table, order='C')  # a writable copy
    if table.dtype.name == 'bfloat16':
        return torch.from_numpy(table.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(table.astype(np.float32)).to(device)


@dataclasses.dataclass
class SimState:
    pos_r: torch.Tensor      # (N,) int32 current row
    pos_c: torch.Tensor      # (N,) int32 current col
    mem: torch.Tensor        # (max(K, 1), N) int32 move ring buffer
    #                          (init 4), oldest move first (row 0)
    alive: torch.Tensor      # (N,) bool
    palive: torch.Tensor     # (N,) bool: previous step's alive flag — the
    #                          weight of the carried position in the
    #                          pending (delayed) presence update
    presence: torch.Tensor   # (nrow, ncol) int32; steps add into it in
    #                          place
    step: int                # steps taken, saturating at nsteps
    # make_step_fn's step returns new position, memory and flag tensors;
    # make_chunk_fn's advance updates them in place


def init_state(params: TrackParams, start_rc, valid=None,
               device=None) -> SimState:
    """Initial state. The start cell counts toward presence (the
    reference trajectory includes the start, ssrs/movmodel.py:281-283):
    it is the first pending delayed update (``palive = valid``).
    ``valid`` marks real agents; others start dead and count nothing."""
    pos = torch.as_tensor(start_rc, dtype=torch.int32, device=device)
    n = pos.shape[0]
    # every state tensor is the state's own: the chunk kernel updates them
    # in place
    alive = torch.ones(n, dtype=torch.bool, device=pos.device) \
        if valid is None else torch.as_tensor(valid, dtype=torch.bool,
                                              device=pos.device).clone()
    own = torch.contiguous_format
    return SimState(
        pos_r=pos[:, 0].clone(memory_format=own),
        pos_c=pos[:, 1].clone(memory_format=own),
        mem=torch.full((max(params.memory_k, 1), n), 4, dtype=torch.int32,
                       device=pos.device),
        alive=alive, palive=alive.clone(),
        presence=torch.zeros(params.grid_shape, dtype=torch.int32,
                             device=pos.device),
        step=0)


def state_from_numpy(params: TrackParams, pos_r, pos_c, mem, alive, palive,
                     step, presence, device) -> SimState:
    """The port's state from the arrays of a JAX ``SimState``, as numpy.

    JAX's presence map is tile-padded to (nrow_p, ncol_p); it is cut to
    (nrow, ncol). JAX's int32 ``palive`` becomes a bool."""
    nrow, ncol = params.grid_shape

    def dev(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return SimState(
        pos_r=dev(pos_r, torch.int32), pos_c=dev(pos_c, torch.int32),
        mem=dev(mem, torch.int32), alive=dev(alive, torch.bool),
        palive=dev(np.asarray(palive) != 0, torch.bool),
        presence=dev(np.asarray(presence)[:nrow, :ncol], torch.int32),
        step=int(step))


# flushes since the last reset_flush_count(); a flush on the card launches
# presence_flush once
_flushes = 0


def flush_count() -> int:
    """Number of :func:`flush_pending` calls."""
    return _flushes


def reset_flush_count() -> None:
    global _flushes
    _flushes = 0


def flush_pending(state: SimState) -> SimState:
    """Add the pending delayed-presence contribution (the carried
    positions weighted by ``palive``) into ``state.presence`` in place,
    through one launch of the flush kernel (``agents/presence_hist.py``),
    and give the state a new, cleared ``palive`` so later steps cannot
    count it twice (the old one may be ``state.alive`` itself, and stays
    as it is). Call at the end of a run and before any compaction of the
    agent axis."""
    global _flushes
    palive = presence_flush(state.pos_r, state.pos_c, state.palive,
                            state.presence)
    _flushes += 1
    return dataclasses.replace(state, palive=palive)


def make_step_fn(params: TrackParams, base_flat: Optional[torch.Tensor],
                 dirp: torch.Tensor, restr: torch.Tensor):
    """The per-step transition ``step(state, u=None, generator=None)``.

    ``base_flat`` is the ``(nrow*ncol, 9)`` table from
    :func:`prepared_weights`, or None for the directed random walk (every
    cell's weights are ``dirp`` with its center zeroed); ``restr`` the
    (9, 9) restriction table.
    Uniforms ``u`` may be injected; otherwise they are drawn from
    ``generator``. Callers must :func:`flush_pending` at the end.
    """
    def step(state: SimState, u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> SimState:
        nrow, ncol = params.grid_shape
        alive, pr, pc = alive_and_push(state.step, state.alive, state.pos_r,
                                       state.pos_c, nrow, ncol, params.burnin,
                                       params.nsteps)
        if u is None:
            u = torch.rand(state.pos_r.shape[0], generator=generator,
                           dtype=torch.float32, device=state.pos_r.device)
        new_r, new_c, new_mem = fused_step(
            base_flat, restr, dirp, pr, pc, state.pos_r, state.pos_c,
            alive, state.palive, state.mem, u, state.presence,
            nu=params.nu, memory_k=params.memory_k)
        # the counter saturates at the cap
        return SimState(pos_r=new_r, pos_c=new_c, mem=new_mem, alive=alive,
                        palive=alive, presence=state.presence,
                        step=min(state.step + 1, params.nsteps))

    return step


# the most uniforms one chunk launch draws as a block: 2**26 float32
# values (256 MiB); a chunk of more agent-steps runs as several launches
UNIFORM_BLOCK = 2 ** 26


def make_chunk_fn(params: TrackParams, base_flat: Optional[torch.Tensor],
                  dirp: torch.Tensor, restr: torch.Tensor):
    """The chunk transition ``advance(state, steps, generator, emit=None)``.

    ``base_flat`` as in :func:`make_step_fn`. It runs ``steps`` steps from
    ``state.step`` and returns the state with the step counter advanced
    (saturating at the cap). Each launch of the
    chunk kernel (``agents/fused_chunk.py``) covers up to
    ``UNIFORM_BLOCK // N`` steps, whose uniforms it draws from
    ``generator`` as one ``(T, N)`` block; the state tensors are updated
    in place. ``emit``: optional ``(positions int16 (steps, N, 2), flags
    bool (steps, N))`` that receive each step's new positions and alive
    flags. A direction memory longer than ``MAX_MEMORY_K`` takes the
    per-step loop of :func:`make_step_fn`. Callers must
    :func:`flush_pending` at the end.
    """
    if params.memory_k > MAX_MEMORY_K:
        step = make_step_fn(params, base_flat, dirp, restr)

        def advance_by_step(state: SimState, steps: int,
                            generator: torch.Generator, emit=None):
            for t in range(steps):
                state = step(state, generator=generator)
                if emit is not None:
                    emit[0][t, :, 0] = state.pos_r
                    emit[0][t, :, 1] = state.pos_c
                    emit[1][t] = state.alive
            return state

        return advance_by_step

    def advance(state: SimState, steps: int, generator: torch.Generator,
                emit=None) -> SimState:
        n = state.pos_r.shape[0]
        block = max(1, UNIFORM_BLOCK // max(n, 1))
        for t0 in range(0, steps, block):
            t_len = min(block, steps - t0)
            u = torch.rand((t_len, n), generator=generator,
                           dtype=torch.float32, device=state.pos_r.device)
            fused_chunk(
                base_flat, restr, dirp, state.pos_r, state.pos_c, state.mem,
                state.alive, state.palive, u, state.presence, nu=params.nu,
                memory_k=params.memory_k, s0=state.step,
                burnin=params.burnin, nsteps=params.nsteps,
                emit=None if emit is None else
                (emit[0][t0:t0 + t_len], emit[1][t0:t0 + t_len]))
            state = dataclasses.replace(
                state, step=min(state.step + t_len, params.nsteps))
        return state

    return advance


def _bucket_for(n_alive: int, min_bucket: int, quantum: int = 1) -> int:
    """Smallest {1, 1.5} * 2^k >= n_alive (>= min_bucket) that is also a
    multiple of ``quantum``. The 1.5x rungs bound the dead slots a bucket
    carries before the next compaction at 1.5x instead of 2x."""
    n = max(n_alive, min_bucket, 1)
    p = 1 << max(n.bit_length() - 1, 0)      # largest pow2 <= n
    if p >= n:
        m = p
    elif 3 * p // 2 >= n:
        m = 3 * p // 2
    else:
        m = 2 * p
    return ((m + quantum - 1) // quantum) * quantum


def _norm_tail_bucket(tail_bucket, min_bucket: int) -> int:
    """Normalize the ``tail_bucket`` knob (Config.track_tail_bucket can
    arrive from a run JSON): 0 -> stop compacting at ``min_bucket``,
    negative int -> -1 (never switch; compaction still stops at
    ``min_bucket``), positive int -> that bucket floored at
    ``min_bucket``. ``'auto'`` (the JAX package's self-tuned switch) is
    not ported."""
    if tail_bucket == 'auto':
        raise NotImplementedError(
            "tail_bucket='auto' is not ported: it tunes the JAX package's "
            'remote-dispatch tail and has no counterpart on a local card')
    if isinstance(tail_bucket, (int, np.integer)) \
            and not isinstance(tail_bucket, bool):
        tb = int(tail_bucket)
        if tb == 0:
            return min_bucket
        return -1 if tb < 0 else max(min_bucket, tb)
    raise ValueError(
        "tail_bucket must be 0 (switch at min_bucket), a negative int "
        '(never switch), or a positive int bucket; got '
        f'{tail_bucket!r}')


def _compact_body(state: SimState, m: int):
    """Flush, stable-pack alive agents to the front, truncate to bucket
    m. Returns (state, order)."""
    state = flush_pending(state)
    # argsort on CUDA wants an integer key; alive agents (key 0) first
    order = torch.argsort((~state.alive).to(torch.int32), stable=True)[:m]
    return dataclasses.replace(
        state, pos_r=state.pos_r[order], pos_c=state.pos_c[order],
        mem=state.mem[:, order], alive=state.alive[order],
        palive=state.palive[order]), order


def _prologue(params: TrackParams, start_rc, generator: torch.Generator,
              updraft, potential, valid, base_flat, dirp, chunked=True):
    """The initial state and the chunk function (:func:`make_chunk_fn`;
    the step function of :func:`make_step_fn` unless ``chunked``) of a
    driver, on ``generator.device``; the weight table is built from
    ``updraft`` and ``potential`` unless ``base_flat`` is given. With
    neither a table nor an updraft the run has no table: the directed
    random walk."""
    device = generator.device
    if dirp is None:
        dirp = torch.from_numpy(directional_probs(params.move_dirn))
    dirp = torch.as_tensor(dirp).to(device=device, dtype=torch.float32)
    restr = torch.from_numpy(restriction_table()).to(device)
    if base_flat is None and updraft is not None:
        updraft = torch.as_tensor(updraft, dtype=torch.float32,
                                  device=device)
        if potential is not None:
            potential = torch.as_tensor(potential, dtype=torch.float32,
                                        device=device)
        base_flat = prepared_weights(updraft, potential, dirp,
                                     params.weight_dtype)
    state = init_state(params, start_rc, valid=valid, device=device)
    make = make_chunk_fn if chunked else make_step_fn
    return state, make(params, base_flat, dirp, restr)


def simulate_presence(params: TrackParams, start_rc,
                      generator: torch.Generator, updraft=None,
                      potential=None, record_tracks: bool = False,
                      chunk: int = 128, valid=None,
                      base_flat: Optional[torch.Tensor] = None,
                      dirp: Optional[torch.Tensor] = None):
    """Presence simulation without compaction (the counterpart of the
    JAX package's jitted ``simulate_presence``).

    Runs on ``generator.device``; ``base_flat``, ``dirp`` and ``valid`` as
    in :func:`simulate_presence_compacting`.

    Without ``record_tracks``: chunks of ``chunk`` steps, reading the
    alive count once per chunk, until every agent is dead or after
    ``params.nsteps`` steps. Returns ``(presence int32 (nrow, ncol),
    steps taken)``.

    With ``record_tracks``: all ``params.nsteps`` steps, and also the
    ``(nsteps+1, N, 2)`` int16 track array (the starts, then each step's
    new positions; a dead agent repeats its last cell) and the int32
    ``(N,)`` lengths, 1 (the start) plus the moves made. Small runs only:
    the array takes ``nsteps * N * 4`` bytes on the device. Returns
    ``(presence, steps, tracks, lengths)``.
    """
    state, step = _prologue(params, start_rc, generator, updraft,
                            potential, valid, base_flat, dirp, chunked=False)
    if record_tracks:
        n = state.pos_r.shape[0]
        tracks = torch.empty((params.nsteps + 1, n, 2), dtype=torch.int16,
                             device=state.pos_r.device)
        tracks[0, :, 0] = state.pos_r
        tracks[0, :, 1] = state.pos_c
        lengths = torch.ones(n, dtype=torch.int32, device=tracks.device)
        for t in range(1, params.nsteps + 1):
            state = step(state, generator=generator)
            tracks[t, :, 0] = state.pos_r
            tracks[t, :, 1] = state.pos_c
            lengths += state.alive
        state = flush_pending(state)
        return state.presence, state.step, tracks, lengths
    # optimistic initial count, as in simulate_presence_compacting
    n_alive = state.pos_r.shape[0]
    while state.step < params.nsteps and n_alive > 0:
        for _ in range(min(chunk, params.nsteps - state.step)):
            state = step(state, generator=generator)
        n_alive = int(state.alive.sum())
    state = flush_pending(state)
    return state.presence, state.step


def simulate_presence_compacting(params: TrackParams, start_rc,
                                 generator: torch.Generator,
                                 updraft=None, potential=None,
                                 chunk: int = 512,
                                 min_bucket: int = 1024,
                                 valid=None,
                                 tail_bucket=0,
                                 base_flat: Optional[torch.Tensor] = None,
                                 dirp: Optional[torch.Tensor] = None):
    """Presence simulation with dead-agent compaction.

    Runs on ``generator.device``. ``base_flat``: an already-prepared
    ``(nrow*ncol, 9)`` weight table; when given, ``updraft`` and
    ``potential`` are ignored. With neither a table nor an updraft the
    run is the directed random walk (no table). ``dirp`` optionally
    overrides the directional prior derived from ``params.move_dirn``.

    A Python loop over chunks of ``chunk`` steps (each one launch of the
    chunk kernel per ``UNIFORM_BLOCK`` uniforms, :func:`make_chunk_fn`)
    reads the alive count once per chunk; whenever the live population
    falls below the current bucket, the survivors are packed into the
    next {1,1.5}*2^k bucket.
    ``tail_bucket`` sets the bucket below which no compaction happens
    (:func:`_norm_tail_bucket`). The run stops when every agent is dead
    or after ``params.nsteps`` steps. Deterministic for a fixed generator
    state on one device.

    Returns (presence int32 (nrow, ncol) on the device, steps taken).
    """
    state, advance = _prologue(params, start_rc, generator, updraft,
                               potential, valid, base_flat, dirp)
    floor = max(min_bucket, _norm_tail_bucket(tail_bucket, min_bucket))
    # optimistic initial count: a population that starts all dead ends
    # the loop after one chunk of no-op steps
    n_alive = state.pos_r.shape[0]
    while state.step < params.nsteps and n_alive > 0:
        state = advance(state, min(chunk, params.nsteps - state.step),
                        generator)
        n_alive = int(state.alive.sum())
        state = _shrink(state, n_alive, floor, min_bucket)
    state = flush_pending(state)
    return state.presence, state.step


def _shrink(state: SimState, n_alive: int, floor: int,
            min_bucket: int) -> SimState:
    """The compacting drivers' decision after a chunk: a population above
    ``floor`` slots whose ``n_alive`` survivors fit a smaller bucket is
    packed into it."""
    cur = state.pos_r.shape[0]
    if n_alive > 0 and cur > floor:
        m = _bucket_for(n_alive, min_bucket)
        if m < cur:
            state, _ = _compact_body(state, m)
    return state


def _case_starts(start_rc, n_cases: int):
    """The cases drivers' starts, one entry a case: shared ``(N, 2)``
    starts (an array, or a nested list of ``[r, c]`` pairs), ``(C, N, 2)``
    per-case starts, or a list or tuple of C ``(N, 2)`` arrays."""
    if isinstance(start_rc, (list, tuple)) \
            and all(np.ndim(s) == 2 for s in start_rc):
        if len(start_rc) != n_cases:
            raise ValueError(
                f'per-case start_rc list has {len(start_rc)} entries '
                f'for {n_cases} cases')
        return list(start_rc)
    if not isinstance(start_rc, torch.Tensor):
        start_rc = np.asarray(start_rc)
    if start_rc.ndim not in (2, 3):
        raise ValueError(
            'start_rc must be (N, 2) shared starts or (C, N, 2) '
            f'per-case starts; got shape {tuple(start_rc.shape)}')
    if start_rc.ndim == 2:
        return [start_rc] * n_cases
    if len(start_rc) != n_cases:
        raise ValueError(
            f'per-case start_rc has {len(start_rc)} entries for '
            f'{n_cases} cases')
    return [start_rc[i] for i in range(n_cases)]


def simulate_presence_cases(params: TrackParams, base_tables, dirps,
                            start_rc, generators, chunk: int = 128):
    """Multi-case simulation without compaction (the counterpart of the
    JAX package's vmapped ``simulate_presence_cases``): case i is one run
    of :func:`simulate_presence` with ``base_tables[i]``, ``dirps[i]``,
    its starts (:func:`_case_starts`) and ``generators[i]``.

    Returns (presence int32 (C, nrow, ncol) on the device, steps int32
    (C,) numpy).
    """
    starts = _case_starts(start_rc, len(base_tables))
    runs = [simulate_presence(params, starts[i], generators[i], chunk=chunk,
                              base_flat=base_tables[i], dirp=dirps[i])
            for i in range(len(base_tables))]
    return (torch.stack([p for p, _ in runs]),
            np.array([s for _, s in runs], np.int32))


def simulate_presence_cases_compacting(params: TrackParams, base_tables,
                                       start_rc, generators,
                                       dirps=None,
                                       chunk: int = 512,
                                       min_bucket: int = 1024,
                                       tail_bucket=0,
                                       valid=None):
    """Multi-case presence simulation: the seasonal and sweep production
    path. Every case runs the compacting pipeline of
    :func:`simulate_presence_compacting` (chunk kernel, dead-agent
    compaction, early exit of its own), ROUND-ROBIN INTERLEAVED: each
    round enqueues one chunk and its alive count for every case still
    active before it reads any case's count, so the card works through
    the other cases' chunks while the host waits for one count and packs
    that case.

    Case i draws from ``generators[i]`` exactly as the single-case driver
    would: its result is bit-identical to
    :func:`simulate_presence_compacting` with a generator of the same
    seed, the same table and the same starts.

    Parameters
    ----------
    base_tables : (C, nrow*ncol, 9) stacked prepared tables
        (:func:`prepared_weights_batch`), or a list of C tables; an entry
        may be None (no table: the directed random walk)
    start_rc : (N, 2) shared starts, (C, N, 2) per-case starts, or a list
        of C (N, 2) arrays; every case's state owns copies of them
    generators : C ``torch.Generator``s on one device, where the run
        takes place
    dirps : optional (C, 9) per-case directional priors; None derives the
        shared prior from ``params.move_dirn``
    tail_bucket : as in :func:`simulate_presence_compacting`

    What bounds C is device memory: each case holds its table, its state
    and its map for the whole run, and a chunk's uniforms while it is in
    flight, up to ``UNIFORM_BLOCK`` float32 values (256 MiB; 205 MB at
    100,000 agents and 512 steps). All cases run on the caller's stream,
    where the allocator hands one such block from case to case, so a round
    may hold fewer than C blocks, and C x 256 MiB at most.

    Returns (presence int32 (C, nrow, ncol) on the device, steps int32
    (C,) numpy).
    """
    n_cases = len(base_tables)
    starts = _case_starts(start_rc, n_cases)
    floor = max(min_bucket, _norm_tail_bucket(tail_bucket, min_bucket))
    states, advances = {}, {}
    for i in range(n_cases):
        states[i], advances[i] = _prologue(
            params, starts[i], generators[i], None, None, valid,
            base_tables[i], None if dirps is None else dirps[i])
    active = list(range(n_cases))
    while active:
        # enqueue: one chunk and its alive count for every active case;
        # nothing here waits for the card
        counts = {}
        for i in active:
            st = states[i]
            states[i] = advances[i](
                st, min(chunk, params.nsteps - st.step), generators[i])
            counts[i] = states[i].alive.sum()
        # read: the card runs the later cases' chunks while the host
        # reads and packs the earlier ones
        still = []
        for i in active:
            n_alive = int(counts[i])
            if states[i].step >= params.nsteps or n_alive == 0:
                states[i] = flush_pending(states[i])
            else:
                states[i] = _shrink(states[i], n_alive, floor, min_bucket)
                still.append(i)
        active = still
    return (torch.stack([states[i].presence for i in range(n_cases)]),
            np.array([states[i].step for i in range(n_cases)], np.int32))


class RecordedRun(NamedTuple):
    """What the recording driver produced, and how."""
    presence: torch.Tensor     # (nrow, ncol) int32 on the device
    tracks: List[np.ndarray]   # per agent, int16 (len, 2), agent order
    steps: int                 # steps taken
    builder: str               # 'native' (C++) or 'python'
    build_seconds: float       # host seconds spent rebuilding the tracks


_TORCH_VIEWS = (torch.int16, torch.int32, torch.bool)
_NUMPY_VIEWS = (np.int16, np.int32, np.bool_)


def _split_emissions(buf, t_len: int, b: int, views):
    """Views of one chunk's emission buffer, a flat byte array (torch on
    the device or numpy on the host, ``views`` names the dtypes): the
    positions int16 ``(t_len, b, 2)``, the id vector int32 ``(b,)`` and
    the alive flags bool ``(t_len, b)``."""
    i16, i32, flag = views
    npos, nids = 4 * t_len * b, 4 * b
    return (buf[:npos].view(i16).reshape(t_len, b, 2),
            buf[npos:npos + nids].view(i32),
            buf[npos + nids:].view(flag).reshape(t_len, b))


def simulate_tracks_recorded(params: TrackParams, start_rc,
                             generator: torch.Generator, updraft=None,
                             potential=None, chunk: int = 512,
                             min_bucket: int = 1024,
                             base_flat: Optional[torch.Tensor] = None,
                             dirp: Optional[torch.Tensor] = None
                             ) -> RecordedRun:
    """Full-trajectory simulation with early exit and compaction.

    The compacting loop of :func:`simulate_presence_compacting` (same
    ``chunk``, ``min_bucket``, bucket ladder and stable compaction, no
    tail bucket), whose chunk kernel also writes each step's new
    positions (int16) and alive flags into a per-chunk device buffer,
    beside the id vector that maps batch slots to agents; compaction
    permutes the ids with the order it packs the agents by. The buffer
    comes to the host in one copy per chunk, and the track builder
    (``ssrs_tpu_torch.native``) appends each agent's alive prefix of the
    chunk to its trajectory. So
    the step cap can be the reference's ``(nrow/2)*(ncol/2)`` without a
    dense ``(cap, N, 2)`` array.

    Returns a :class:`RecordedRun`: its first two fields are the JAX
    driver's pair (presence int32 (nrow, ncol) on the device, list of
    int16 ``(len, 2)`` trajectories in agent order, reference format,
    ssrs/movmodel.py:318), then the steps taken and the builder's name
    and seconds.
    """
    start_rc = np.asarray(start_rc, np.int32)
    state, advance = _prologue(params, start_rc, generator, updraft,
                               potential, None, base_flat, dirp)
    device = state.pos_r.device
    builder = make_builder(start_rc.astype(np.int16))
    ids = torch.arange(start_rc.shape[0], dtype=torch.int32, device=device)
    build_s = 0.
    n_alive = ids.shape[0]
    while state.step < params.nsteps and n_alive > 0:
        t_len = min(chunk, params.nsteps - state.step)
        b = ids.shape[0]
        buf = torch.empty(5 * t_len * b + 4 * b, dtype=torch.uint8,
                          device=device)
        pos, ids_out, alive = _split_emissions(buf, t_len, b, _TORCH_VIEWS)
        ids_out.copy_(ids)
        state = advance(state, t_len, generator, emit=(pos, alive))
        # the chunk's one device-to-host copy
        pos_h, ids_h, alive_h = _split_emissions(buf.cpu().numpy(), t_len,
                                                 b, _NUMPY_VIEWS)
        # the last row holds the alive flags after the chunk
        n_alive = int(alive_h[-1].sum())
        t0 = time.perf_counter()
        builder.append_chunk(pos_h, alive_h, ids_h)
        build_s += time.perf_counter() - t0
        if n_alive > 0 and b > min_bucket:
            m = _bucket_for(n_alive, min_bucket)
            if m < b:
                state, order = _compact_body(state, m)
                ids = ids[order]
    state = flush_pending(state)
    t0 = time.perf_counter()
    tracks = builder.export()
    build_s += time.perf_counter() - t0
    return RecordedRun(state.presence, tracks, state.step, builder.kind,
                       build_s)
