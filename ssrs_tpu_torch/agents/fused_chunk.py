"""The chunk kernel: T agent steps in one launch, and its plain version.

T consecutive steps of the movement model for every agent, from global
step ``s0``: each is the alive rule and burn-in push
(:func:`~.fused_step.alive_and_push`), the delayed presence count, and
the step of :func:`~.fused_step.fused_step_plain`; then ``palive =
alive``. It is the counterpart of ``ssrs_tpu/agents/fused_step.py::
_fused_kernel`` together with the ``lax.scan`` chunks that drive it in
the JAX package (``simulate.py::_run_chunk``, ``_run_chunk_recording``),
so a driver launches once per chunk and not several times per step.

- :func:`fused_chunk` is the wrapper. On CUDA tensors it launches
  ``csrc/fused_chunk.cu`` or raises; on CPU tensors it runs
  :func:`fused_chunk_plain`.
- :func:`fused_chunk_plain` is a loop of T plain steps.

Both UPDATE THE STATE IN PLACE: ``r``, ``c``, ``mem``, ``alive``,
``palive`` and ``presence``. The positions after the last step stay
pending (``palive``) for ``agents.simulate.flush_pending``, as after T
single steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .fused_step import (alive_and_push, check_table, fused_step_plain,
                         table_launch_args)

# the kernel keeps the direction-memory ring in registers, up to this
# length; longer memories take the per-step kernel
MAX_MEMORY_K = 8

# launches of the CUDA kernel, and the steps they covered, since the last
# reset_launch_count()
_launches = 0
_steps = 0


def launch_count() -> int:
    """Number of CUDA kernel launches :func:`fused_chunk` has made."""
    return _launches


def steps_count() -> int:
    """Steps covered by those launches (the sum of their T)."""
    return _steps


def reset_launch_count() -> None:
    global _launches, _steps
    _launches = 0
    _steps = 0


def fused_chunk_plain(table: Optional[torch.Tensor], restr: torch.Tensor,
                      dirp: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                      mem: torch.Tensor, alive: torch.Tensor,
                      palive: torch.Tensor, u: torch.Tensor,
                      presence: torch.Tensor, *, nu: float, memory_k: int,
                      s0: int, burnin: int, nsteps: int,
                      emit: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> None:
    """Plain PyTorch version of :func:`fused_chunk` (same arguments, same
    in-place updates)."""
    nrow, ncol = presence.shape
    for t in range(u.shape[0]):
        a, pr, pc = alive_and_push(s0 + t, alive, r, c, nrow, ncol, burnin,
                                   nsteps)
        new_r, new_c, new_mem = fused_step_plain(
            table, restr, dirp, pr, pc, r, c, a, palive, mem, u[t], presence,
            nu=nu, memory_k=memory_k)
        r.copy_(new_r)
        c.copy_(new_c)
        mem.copy_(new_mem)
        palive.copy_(a)
        alive.copy_(a)
        if emit is not None:
            emit[0][t, :, 0] = r
            emit[0][t, :, 1] = c
            emit[1][t] = a


def _check(table, restr, dirp, r, c, mem, alive, palive, u, presence,
           memory_k, emit):
    if presence.dim() != 2 or presence.dtype != torch.int32:
        raise ValueError('presence must be an int32 (nrow, ncol) tensor, '
                         f'got {presence.dtype} {tuple(presence.shape)}')
    nrow, ncol = presence.shape
    n = r.shape[0]
    steps = u.shape[0] if u.dim() == 2 else -1
    check_table(table, nrow, ncol)
    if not 0 <= memory_k <= MAX_MEMORY_K:
        raise ValueError(f'memory_k must be in [0, {MAX_MEMORY_K}] for the '
                         f'chunk kernel, got {memory_k}')
    expected = [
        ('restr', restr, torch.float32, (9, 9)),
        ('dirp', dirp, torch.float32, (9,)),
        ('r', r, torch.int32, (n,)), ('c', c, torch.int32, (n,)),
        ('mem', mem, torch.int32, (max(memory_k, 1), n)),
        ('alive', alive, torch.bool, (n,)),
        ('palive', palive, torch.bool, (n,)),
        ('u', u, torch.float32, (steps, n)),
        ('presence', presence, torch.int32, (nrow, ncol))]
    if table is not None:
        expected.append(('table', table, table.dtype, tuple(table.shape)))
    if emit is not None:
        expected += [('emit positions', emit[0], torch.int16, (steps, n, 2)),
                     ('emit flags', emit[1], torch.bool, (steps, n))]
    dev = presence.device
    for name, t, dtype, shape in expected:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {dtype} of shape {shape}, '
                             f'got {t.dtype} {tuple(t.shape)}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, presence on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def fused_chunk(table: Optional[torch.Tensor], restr: torch.Tensor,
                dirp: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                mem: torch.Tensor, alive: torch.Tensor, palive: torch.Tensor,
                u: torch.Tensor, presence: torch.Tensor, *, nu: float,
                memory_k: int, s0: int, burnin: int, nsteps: int,
                emit: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> None:
    """Steps ``s0 .. s0+T-1`` of the whole population, in place.

    Parameters
    ----------
    table : (nrow*ncol, 9) float32 or bfloat16 prepared move weights
        (``agents.simulate.prepared_weights``); None for the directed
        random walk, whose weights are ``dirp`` with its center zeroed in
        every cell
    restr : (9, 9) float32 restriction table (``agents.moves``)
    dirp : (9,) float32 directional prior
    r, c : (N,) int32 carried positions, UPDATED IN PLACE
    mem : (max(memory_k, 1), N) int32 move ring, oldest first, UPDATED IN
        PLACE (passed through when memory_k == 0)
    alive, palive : (N,) bool, UPDATED IN PLACE
    u : (T, N) float32 uniforms in [0, 1); row t is step s0 + t's
    presence : (nrow, ncol) int32 counts; the delayed counts of the T
        steps are ADDED INTO IT IN PLACE
    memory_k : 0 .. ``MAX_MEMORY_K``; longer memories raise
    s0, burnin, nsteps : the global step of row 0, the burn-in length and
        the step cap (from the cap on nobody is alive)
    emit : optional ``(positions int16 (T, N, 2), flags bool (T, N))``:
        each step's new positions and alive flags are written there (the
        rows of a chunk's emission buffer, ``agents.simulate``)

    All tensors must lie on one device and be contiguous. On a CUDA
    device the call launches the CUDA kernel (or raises); on the CPU it
    runs :func:`fused_chunk_plain`.
    """
    _check(table, restr, dirp, r, c, mem, alive, palive, u, presence,
           memory_k, emit)
    if presence.device.type == 'cpu':
        fused_chunk_plain(table, restr, dirp, r, c, mem, alive, palive, u,
                          presence, nu=nu, memory_k=memory_k, s0=s0,
                          burnin=burnin, nsteps=nsteps, emit=emit)
        return
    if presence.device.type != 'cuda':
        raise ValueError(f'fused_chunk runs on cuda or cpu tensors, got '
                         f'{presence.device}')
    steps, n = u.shape
    if steps == 0 or n == 0:
        return
    from .._build import load_library
    lib = load_library()
    launch, table_ptr = table_launch_args(lib, 'fused_chunk', table)
    nrow, ncol = presence.shape
    emit_pos, emit_alive = (None, None) if emit is None else \
        (emit[0].data_ptr(), emit[1].data_ptr())
    with torch.cuda.device(presence.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(table_ptr, restr.data_ptr(), dirp.data_ptr(),
                     r.data_ptr(), c.data_ptr(), mem.data_ptr(),
                     alive.data_ptr(), palive.data_ptr(), u.data_ptr(),
                     presence.data_ptr(), emit_pos, emit_alive, n, nrow,
                     ncol, memory_k, float(nu), s0, steps, burnin, nsteps,
                     stream)
    if err != 0:
        raise RuntimeError(f'fused_chunk kernel launch failed: CUDA error '
                           f'{err}')
    global _launches, _steps
    _launches += 1
    _steps += steps
