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

It also holds the legacy entry points of the JAX module,
:func:`solve_potential` and :func:`solve_potential_for_direction`: the
row-normalized multigrid of ``multigrid.py`` (``potential_solver='mg'``),
which reaches the float32-representable fixed point of ``I - P``. For
answers to the float64 direct solve's accuracy on hard fields, the
``Simulator``'s default is ``lap.solve_potential_refined``.
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


def _on_device(conductivity, device, name: str) -> torch.Tensor:
    """A conductivity (a tensor, or numpy with an explicit ``device``) as
    float32 on its device."""
    if torch.is_tensor(conductivity):
        return conductivity.to(torch.float32)
    if device is None:
        raise ValueError(f'{name}: a numpy conductivity needs an explicit '
                         'device=')
    return torch.as_tensor(np.asarray(conductivity, np.float32),
                           device=torch.device(device))


def weight_planes(conductivity) -> torch.Tensor:
    """Unnormalized edge weights ``W_d = hm(cond_i, cond_j) / fac_d`` for
    the eight neighbours in ``_DIRS`` order, shape (8, nrow, ncol)
    float32, zero for out-of-grid neighbours, on the conductivity's
    device; (8, C, nrow, ncol) for a batch of C fields. The row-normalized planes of :func:`transition_planes` are
    ``W / sum_d W``."""
    cond = torch.as_tensor(conductivity, dtype=torch.float32)
    nrow, ncol = cond.shape[-2:]
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


def _apply_p(p_planes: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(P u)(r, c) = sum_d P_d(r, c) * u(r+dr, c+dc): one pad and eight
    slices, in ``_DIRS`` order."""
    nrow, ncol = u.shape[-2:]
    upad = F.pad(u, (1, 1, 1, 1))
    out = torch.zeros_like(u)
    for k, m in enumerate(_DIRS):
        dr, dc = int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1])
        out = out + p_planes[k] * upad[..., dr + 1:dr + 1 + nrow,
                                       dc + 1:dc + 1 + ncol]
    return out


def solve_potential(conductivity, bmask, bvals, tol: float = 1e-6,
                    maxiter: int = 0, device=None, stats=None):
    """The legacy row-normalized multigrid solve of the directional
    potential (``multigrid.solve_potential_mg``), ``maxiter`` V-cycles at
    most (<= 0: 200). A tensor conductivity is solved on its device; a
    numpy one on ``device``, which it then requires. Returns (potential
    float32 (nrow, ncol) tensor, residual norm float); ``stats``, a dict,
    receives ``vcycles``."""
    from .multigrid import solve_potential_mg
    maxcycles = maxiter if maxiter > 0 else 200
    return solve_potential_mg(conductivity, bmask, bvals, tol=tol,
                              maxcycles=maxcycles, device=device,
                              stats=stats)


def solve_potential_for_direction(conductivity, move_dirn: float,
                                  tol: float = 1e-6, maxiter: int = 0,
                                  device=None, stats=None):
    """:func:`solve_potential` with the directed boundary conditions of
    ``move_dirn`` (``Simulator.get_directional_potential``,
    ssrs/simulator.py:259-288, without the file cache)."""
    from .boundary import boundary_masks
    bmask, bvals = boundary_masks(move_dirn, tuple(conductivity.shape))
    return solve_potential(conductivity, bmask, bvals, tol=tol,
                           maxiter=maxiter, device=device, stats=stats)
