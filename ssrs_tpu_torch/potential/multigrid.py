"""Geometric multigrid for the row-normalized directional-potential system
(``potential_solver='mg'``).

The PyTorch counterpart of ``ssrs_tpu/potential/multigrid.py``: the
row-normalized 9-point system

    L u = u - (1 - bmask) * (P u) = bmask * bvals

solved by cell-centered V-cycles (weighted-Jacobi smoothing, 2x2
block-average restriction, bilinear prolongation, coarse operators
rediscretized from block-averaged conductivity). Every operation is a
shifted elementwise stencil.

Two differences from the JAX module, neither of them in the arithmetic
of a cycle:

- ``_prolong`` interleaves its four bilinear phases by strided
  assignment. JAX does it with 0/1 selector matmuls because of the TPU's
  lane layout; a matmul would let TF32 into the solve on the card.
- the ``lax.while_loop`` over V-cycles is a host loop that reads the
  residual norm once per cycle, as the refined solver's GCR does.

This solver reaches the float32-representable fixed point of ``I - P``;
on thresholded fields that is not the float64 answer (the refined solver
of ``lap.py`` is). It is kept as the JAX package's public legacy solver.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .solver import _apply_p, _on_device, transition_planes


class MGLevel(NamedTuple):
    p_planes: torch.Tensor  # (8, nrow, ncol) row-normalized transitions
    notb: torch.Tensor      # (nrow, ncol) 1.0 where NOT Dirichlet
    shape: Tuple[int, int]


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of each 2x2 block of an even-shaped field."""
    m, n = x.shape
    return x.reshape(m // 2, 2, n // 2, 2).sum(dim=(1, 3))


def _replicate_odd(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last row and column repeated where its sizes are
    odd."""
    nrow, ncol = x.shape
    if nrow % 2:
        x = torch.cat([x, x[-1:, :]], dim=0)
    if ncol % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
    return x


def _coarsen_field(x: torch.Tensor) -> torch.Tensor:
    """2x2 block average; an odd trailing row or column replicated first."""
    return 0.25 * _block_sum(_replicate_odd(x))


def _coarsen_mask(bmask: torch.Tensor) -> torch.Tensor:
    """A coarse cell is Dirichlet if any fine cell in its block is."""
    return _block_sum(_replicate_odd(bmask).to(torch.float32)) > 0.


def _prolong(e: torch.Tensor, fine_shape: Tuple[int, int]) -> torch.Tensor:
    """Cell-centered bilinear prolongation back to the fine grid
    (9/16-3/16-3/16-1/16 stencil), the four phases written into the
    interleaved fine grid by strided assignment."""
    ep = F.pad(e[None, None], (1, 1, 1, 1), mode='replicate')[0, 0]
    c = ep[1:-1, 1:-1]
    up, down = ep[:-2, 1:-1], ep[2:, 1:-1]
    left, right = ep[1:-1, :-2], ep[1:-1, 2:]
    ul, ur = ep[:-2, :-2], ep[:-2, 2:]
    dl, dr = ep[2:, :-2], ep[2:, 2:]
    m, n = e.shape
    out = torch.empty((2 * m, 2 * n), dtype=e.dtype, device=e.device)
    out[0::2, 0::2] = (9. * c + 3. * up + 3. * left + ul) * (1. / 16.)
    out[0::2, 1::2] = (9. * c + 3. * up + 3. * right + ur) * (1. / 16.)
    out[1::2, 0::2] = (9. * c + 3. * down + 3. * left + dl) * (1. / 16.)
    out[1::2, 1::2] = (9. * c + 3. * down + 3. * right + dr) * (1. / 16.)
    return out[:fine_shape[0], :fine_shape[1]]


def build_levels(conductivity: torch.Tensor, bmask: torch.Tensor,
                 min_size: int = 8) -> List[MGLevel]:
    """The level hierarchy: transition planes of the block-averaged
    conductivity, coarsened until ``min(shape) <= min_size``."""
    levels = []
    cond = conductivity.to(torch.float32)
    mask = bmask.to(torch.bool)
    while True:
        levels.append(MGLevel(p_planes=transition_planes(cond),
                              notb=(~mask).to(torch.float32),
                              shape=tuple(cond.shape)))
        if min(cond.shape) <= min_size:
            break
        cond = _coarsen_field(cond)
        mask = _coarsen_mask(mask)
    return levels


def _residual(level: MGLevel, u: torch.Tensor,
              rhs: torch.Tensor) -> torch.Tensor:
    return rhs - (u - level.notb * _apply_p(level.p_planes, u))


def _smooth(level: MGLevel, u: torch.Tensor, rhs: torch.Tensor,
            omega: float, nsweeps: int) -> torch.Tensor:
    """Weighted Jacobi: diag(L) == 1, so u += omega * (rhs - L u)."""
    for _ in range(nsweeps):
        u = u + omega * _residual(level, u, rhs)
    return u


def vcycle(levels: List[MGLevel], rhs: torch.Tensor, u0: torch.Tensor,
           omega: float = 0.8, nu1: int = 2, nu2: int = 2,
           coarse_sweeps: int = 64) -> torch.Tensor:
    """One V-cycle on L u = rhs."""
    return _cycle(levels, 0, u0, rhs, omega, nu1, nu2, coarse_sweeps)


def _cycle(levels: List[MGLevel], idx: int, u: torch.Tensor,
           rhs: torch.Tensor, omega: float, nu1: int, nu2: int,
           coarse_sweeps: int) -> torch.Tensor:
    """The V-cycle from level ``idx`` down; a module function, as
    ``lap._cycle``, so that no reference cycle keeps the levels alive."""
    level = levels[idx]
    if idx == len(levels) - 1:
        return _smooth(level, u, rhs, omega, coarse_sweeps)
    u = _smooth(level, u, rhs, omega, nu1)
    r = _residual(level, u, rhs)
    coarse = levels[idx + 1]
    r_c = _coarsen_field(r) * coarse.notb
    e_c = _cycle(levels, idx + 1, torch.zeros_like(r_c), r_c, omega, nu1,
                 nu2, coarse_sweeps)
    u = u + _prolong(e_c, level.shape) * level.notb
    return _smooth(level, u, rhs, omega, nu2)


def solve_potential_mg(conductivity, bmask, bvals, tol: float = 1e-6,
                       maxcycles: int = 200, device=None, stats=None
                       ) -> Tuple[torch.Tensor, float]:
    """Solve for the directional potential by V-cycle iteration, until
    ``||r|| <= tol * ||rhs||`` or ``maxcycles`` cycles; the norm is read
    on the host once per cycle.

    A tensor conductivity is solved on its device; a numpy one on
    ``device``, which it then requires. ``bmask`` and ``bvals`` follow it.
    Returns (potential float32 (nrow, ncol) tensor, final residual norm
    float). ``stats``, a dict, receives ``vcycles``."""
    cond = _on_device(conductivity, device, 'solve_potential_mg')
    bmask = torch.as_tensor(bmask, device=cond.device).to(torch.bool)
    bvals = torch.as_tensor(bvals, device=cond.device).to(torch.float32)
    levels = build_levels(cond, bmask)
    rhs = torch.where(bmask, bvals, 0.)
    target = tol * float(torch.linalg.vector_norm(rhs))
    u = torch.where(bmask, bvals, 500.)
    rnorm = float(torch.linalg.vector_norm(_residual(levels[0], u, rhs)))
    it = 0
    while it < maxcycles and rnorm > target:
        u = vcycle(levels, rhs, u)
        rnorm = float(torch.linalg.vector_norm(_residual(levels[0], u, rhs)))
        it += 1
    if stats is not None:
        stats['vcycles'] = it
    return torch.where(bmask, bvals, u).to(torch.float32), rnorm
