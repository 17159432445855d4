"""The fused agent step: CUDA kernel wrapper and its plain PyTorch version.

One step of the lockstep movement model for every agent: the table
gather, the direction-memory mask, the fallback cascade
(ssrs/movmodel.py:220-244), nu sharpening, the inverse-CDF draw from one
uniform per agent, the move, the ring-buffer shift, and the delayed
presence count of the carried position. It is the counterpart of
``ssrs_tpu/agents/fused_step.py::_fused_kernel`` together with the table
gather and the presence histogram that sat beside that kernel in XLA
(``ssrs_tpu/agents/simulate.py::_make_fused_step``).

- :func:`fused_step` is the wrapper. On CUDA tensors it launches
  ``csrc/fused_step.cu`` or raises; on CPU tensors it runs
  :func:`fused_step_plain`.
- :func:`fused_step_plain` is the same function in plain PyTorch, with
  the kernel's arithmetic order (sequential sums written out as nine
  adds), so that for the same uniforms both give the same moves.
- :func:`alive_and_push` is the step's prologue (alive rule and burn-in
  push), shared with the chunk kernel's plain version
  (``agents/fused_chunk.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_TINY = torch.finfo(torch.float32).tiny

# launches of the CUDA kernel since the last reset_launch_count()
_launches = 0


def launch_count() -> int:
    """Number of CUDA kernel launches :func:`fused_step` has made."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def alive_and_push(step: int, alive: torch.Tensor, r: torch.Tensor,
                   c: torch.Tensor, nrow: int, ncol: int, burnin: int,
                   nsteps: int):
    """Step ``step``'s alive flags and the cells its moves start from:
    nobody is alive from the cap on; after the burn-in an agent off the
    interior dies; during it the move starts from the cell the burn-in
    boundary push gives (ssrs/movmodel.py:205-217; note the reference's
    asymmetry: rows pushed when <= 1, cols when <= 0). The rule of one
    step, for the per-step and the chunk kernels' callers."""
    if step >= nsteps:
        return torch.zeros_like(alive), r, c
    if step > burnin:
        in_interior = (r > 0) & (r < nrow - 1) & (c > 0) & (c < ncol - 1)
        return alive & in_interior, r, c
    pr = torch.where(r <= 1, r + 2, torch.where(r >= nrow - 2, r - 2, r))
    pc = torch.where(c <= 0, c + 2, torch.where(c >= ncol - 2, c - 2, c))
    return alive, pr, pc


def fused_step_plain(table: Optional[torch.Tensor], restr: torch.Tensor,
                     dirp: torch.Tensor, pr: torch.Tensor, pc: torch.Tensor,
                     r: torch.Tensor, c: torch.Tensor, alive: torch.Tensor,
                     palive: torch.Tensor, mem: torch.Tensor, u: torch.Tensor,
                     presence: torch.Tensor, *, nu: float, memory_k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused step; arguments and results
    as :func:`fused_step` (it also adds into ``presence`` in place)."""
    nrow, ncol = presence.shape
    n = r.shape[0]
    # delayed presence of the carried position; cells off the grid count
    # nothing
    sel = palive & (r >= 0) & (r < nrow) & (c >= 0) & (c < ncol)
    flat = torch.where(sel, r.long() * ncol + c.long(), 0)
    presence.view(-1).index_add_(0, flat, sel.to(presence.dtype))

    center0 = torch.ones(9, 1, dtype=torch.float32, device=r.device)
    center0[4] = 0.
    dirp_col = dirp.to(torch.float32)[:, None]
    if table is None:
        # no table (the directed random walk): the prior, center zeroed
        p = (dirp_col * center0).expand(9, n)
    else:
        p = table[pr.long() * ncol + pc.long()].to(torch.float32).T  # (9, n)
    if memory_k > 0:
        mask = restr[mem[0].long()].T
        for k in range(1, memory_k):
            mask = mask * restr[mem[k].long()].T
        mask = mask * center0
        p = p * mask
        allz = ~(p != 0.).any(dim=0, keepdim=True)
        p = torch.where(allz, dirp_col * center0 * mask, p)
    allz = ~(p != 0.).any(dim=0, keepdim=True)
    p = torch.where(allz, dirp_col.expand(9, n), p)
    if nu == 0.0:
        p = torch.ones_like(p)
    elif nu != 1.0:
        p = p / p.amax(dim=0, keepdim=True)
        p = torch.where(
            p > 0., torch.exp(nu * torch.log(torch.clamp(p, min=1e-30))),
            torch.zeros_like(p))

    total = torch.zeros(n, dtype=torch.float32, device=p.device)
    for j in range(9):
        total = total + p[j]
    thresh = torch.clamp(u, min=_TINY) * total
    cum = torch.zeros_like(total)
    cnt = torch.zeros(n, dtype=torch.int32, device=p.device)
    for j in range(9):
        cum = cum + p[j]
        cnt = cnt + (cum < thresh).to(torch.int32)
    mi = torch.clamp(cnt, max=8)

    row = torch.div(mi, 3, rounding_mode='floor')
    new_r = torch.where(alive, pr + row - 1, r)
    new_c = torch.where(alive, pc + (mi - row * 3) - 1, c)
    if memory_k > 0:
        shifted = torch.cat([mem[1:memory_k], mi[None]], dim=0)
        new_mem = torch.where(alive[None], shifted, mem)
    else:
        new_mem = mem.clone()
    return new_r, new_c, new_mem


def check_table(table, nrow: int, ncol: int) -> None:
    """A weight table is None (no table) or float32 or bfloat16 of shape
    ``(nrow*ncol, 9)``."""
    if table is not None and (
            table.dtype not in (torch.float32, torch.bfloat16)
            or tuple(table.shape) != (nrow * ncol, 9)):
        raise ValueError('table must be None or float32 or bfloat16 of '
                         f'shape ({nrow * ncol}, 9), got {table.dtype} '
                         f'{tuple(table.shape)}')


def table_launch_args(lib, name: str, table):
    """(the kernel entry point ``ssrs_<name>_<dtype>`` for ``table``'s
    dtype, its table pointer): a missing table is a null pointer to the
    float32 entry."""
    if table is None:
        return getattr(lib, f'ssrs_{name}_f32'), None
    suffix = 'bf16' if table.dtype == torch.bfloat16 else 'f32'
    return getattr(lib, f'ssrs_{name}_{suffix}'), table.data_ptr()


def _check(table, restr, dirp, pr, pc, r, c, alive, palive, mem, u,
           presence, memory_k):
    if presence.dim() != 2 or presence.dtype != torch.int32:
        raise ValueError('presence must be an int32 (nrow, ncol) tensor, '
                         f'got {presence.dtype} {tuple(presence.shape)}')
    nrow, ncol = presence.shape
    n = r.shape[0]
    check_table(table, nrow, ncol)
    if memory_k < 0:
        raise ValueError(f'memory_k must be >= 0, got {memory_k}')
    expected = {
        'restr': (restr, torch.float32, (9, 9)),
        'dirp': (dirp, torch.float32, (9,)),
        'pr': (pr, torch.int32, (n,)), 'pc': (pc, torch.int32, (n,)),
        'r': (r, torch.int32, (n,)), 'c': (c, torch.int32, (n,)),
        'alive': (alive, torch.bool, (n,)),
        'palive': (palive, torch.bool, (n,)),
        'mem': (mem, torch.int32, (max(memory_k, 1), n)),
        'u': (u, torch.float32, (n,)),
    }
    for name, (t, dtype, shape) in expected.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {dtype} of shape {shape}, '
                             f'got {t.dtype} {tuple(t.shape)}')
    dev = presence.device
    tables = [] if table is None else [('table', table)]
    for name, t in [*tables, ('presence', presence),
                    *[(k, v[0]) for k, v in expected.items()]]:
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, presence on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def fused_step(table: Optional[torch.Tensor], restr: torch.Tensor,
               dirp: torch.Tensor, pr: torch.Tensor, pc: torch.Tensor,
               r: torch.Tensor, c: torch.Tensor, alive: torch.Tensor,
               palive: torch.Tensor, mem: torch.Tensor, u: torch.Tensor,
               presence: torch.Tensor, *, nu: float, memory_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused agent step over the whole population.

    Parameters
    ----------
    table : (nrow*ncol, 9) float32 or bfloat16 prepared move weights
        (``agents.simulate.prepared_weights``), gathered at
        ``pr*ncol+pc``; None for the directed random walk, whose weights
        are ``dirp`` with its center zeroed in every cell
    restr : (9, 9) float32 restriction table; row m = moves allowed
        after move m (``agents.moves.restriction_table``)
    dirp : (9,) float32 directional prior
    pr, pc : (N,) int32 positions after the burn-in push
    r, c : (N,) int32 carried positions (kept by dead agents)
    alive : (N,) bool, this step's alive flags
    palive : (N,) bool, the previous step's alive flags
    mem : (max(memory_k, 1), N) int32 move ring buffer, oldest first;
        passed through when memory_k == 0
    u : (N,) float32 uniforms in [0, 1)
    presence : (nrow, ncol) int32 presence counts. The step ADDS INTO IT
        IN PLACE: one count at the carried position ``(r, c)`` of every
        agent with ``palive`` (the delayed count of
        ``agents/simulate.py``).

    Returns (new_r, new_c, new_mem), freshly allocated.

    All tensors must lie on one device and be contiguous. On a CUDA
    device the call launches the CUDA kernel (or raises); on the CPU it
    runs :func:`fused_step_plain`.
    """
    _check(table, restr, dirp, pr, pc, r, c, alive, palive, mem, u,
           presence, memory_k)
    if presence.device.type == 'cpu':
        return fused_step_plain(table, restr, dirp, pr, pc, r, c, alive,
                                palive, mem, u, presence, nu=nu,
                                memory_k=memory_k)
    if presence.device.type != 'cuda':
        raise ValueError(f'fused_step runs on cuda or cpu tensors, got '
                         f'{presence.device}')
    from .._build import load_library
    lib = load_library()
    launch, table_ptr = table_launch_args(lib, 'fused_step', table)
    nrow, ncol = presence.shape
    n = r.shape[0]
    new_r = torch.empty_like(r)
    new_c = torch.empty_like(c)
    new_mem = torch.empty_like(mem)
    with torch.cuda.device(presence.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(table_ptr, restr.data_ptr(), dirp.data_ptr(),
                     pr.data_ptr(), pc.data_ptr(), r.data_ptr(),
                     c.data_ptr(), alive.data_ptr(), palive.data_ptr(),
                     mem.data_ptr(), u.data_ptr(), new_r.data_ptr(),
                     new_c.data_ptr(), new_mem.data_ptr(),
                     presence.data_ptr(), n, nrow, ncol, memory_k,
                     float(nu), stream)
    if err != 0:
        raise RuntimeError(f'fused_step kernel launch failed: CUDA error '
                           f'{err}')
    global _launches
    _launches += 1
    return new_r, new_c, new_mem
