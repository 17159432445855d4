"""Stencil form of the directional-potential system.

The PyTorch counterpart of the stencil part of
``ssrs_tpu/potential/solver.py``. Reference semantics
(``MovModel.solve_sparse_linear_system``, ssrs/movmodel.py:86-128): the
8-neighbour transition graph with edge weights
``harmonic_mean(cond_i, cond_j, 1e-8) / fac``, row-normalized. The
operator is eight shifted elementwise products; no sparse matrix is
built.

Reference quirks reproduced exactly (held against the JAX package in
tests/test_torch_potential.py, and by it against a dense oracle):

- ``harmonic_mean`` returns the floor 1e-8 only when either conductivity
  is exactly zero (ssrs/movmodel.py:442-447); it does not floor small
  values.
- Edge ``fac`` is sqrt(2) for diagonals and 1 for axials *except* on
  east-column non-corner nodes, where the alternating-fac assembly after
  neighbour filtering (ssrs/movmodel.py:66-79) swaps the facs of the
  ``(-1, 0)`` and ``(-1, -1)`` edges.

The legacy row-normalized multigrid entry points of the JAX module
(``solve_potential``, ``solve_potential_for_direction``, ``'mg'``) are
not ported (ROADMAP.md); the solver is ``lap.solve_potential_refined``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..agents.moves import NEIGHBOR_DELTAS

SQRT2 = float(np.sqrt(2.0))

# the eight off-center move indices
_DIRS = [m for m in range(9) if m != 4]


def _fac_plane(dr: int, dc: int, rows: torch.Tensor, cols: torch.Tensor,
               nrow: int, ncol: int) -> torch.Tensor:
    """Per-direction fac divisor as a full (nrow, ncol) float32 plane,
    including the east-column quirk (module docstring). A plane, not a
    Python number: CUDA divides by a host scalar as a multiply by its
    rounded reciprocal, which would move weights by an ulp from the
    CPU's."""
    base = SQRT2 if (dr != 0 and dc != 0) else 1.0
    full = torch.full((nrow, ncol), base, dtype=torch.float32,
                      device=rows.device)
    if (dr, dc) not in ((-1, 0), (-1, -1)):
        return full
    east_inner = (cols == ncol - 1) & (rows >= 1) & (rows <= nrow - 2)
    swapped = SQRT2 if (dr, dc) == (-1, 0) else 1.0
    return torch.where(east_inner, swapped, full)


def _shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """x(r+dr, c+dc), zero outside the grid."""
    nrow, ncol = x.shape[-2:]
    xpad = F.pad(x, (1, 1, 1, 1))
    return xpad[..., dr + 1:dr + 1 + nrow, dc + 1:dc + 1 + ncol]


def weight_planes(conductivity) -> torch.Tensor:
    """Unnormalized edge weights ``W_d = hm(cond_i, cond_j) / fac_d`` for
    the eight neighbours in ``_DIRS`` order, shape (8, nrow, ncol)
    float32, zero for out-of-grid neighbours, on the conductivity's
    device. The row-normalized planes of :func:`transition_planes` are
    ``W / sum_d W``."""
    cond = torch.as_tensor(conductivity, dtype=torch.float32)
    nrow, ncol = cond.shape
    rows = torch.arange(nrow, device=cond.device)[:, None]
    cols = torch.arange(ncol, device=cond.device)[None, :]
    safe_c = torch.where(cond == 0., 1., cond)
    planes = []
    for m in _DIRS:
        dr, dc = int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1])
        nbr = _shift(cond, dr, dc)
        both_nz = (cond != 0.) & (nbr != 0.)
        # guard the reciprocals; selected away when either side is zero
        safe_n = torch.where(nbr == 0., 1., nbr)
        hm = torch.where(both_nz, 2.0 / (1.0 / safe_c + 1.0 / safe_n),
                         1e-8)
        in_grid = ((rows + dr >= 0) & (rows + dr < nrow) &
                   (cols + dc >= 0) & (cols + dc < ncol))
        fac = _fac_plane(dr, dc, rows, cols, nrow, ncol)
        planes.append(torch.where(in_grid, hm / fac, 0.))
    return torch.stack(planes)


def transition_planes(conductivity) -> torch.Tensor:
    """Row-normalized transition probabilities P_d, shape (8, nrow, ncol).

    P_d(r, c) = w_d / sum_d' w_d' with
    w_d = hm(cond(r, c), cond(r+dr, c+dc)) / fac_d for in-grid neighbours,
    hm(a, b) = 2/(1/a + 1/b) if a != 0 and b != 0 else 1e-8.
    """
    w = weight_planes(conductivity)
    return w / torch.sum(w, dim=0, keepdim=True)
