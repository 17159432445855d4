"""Host-side float64 sparse direct solve of the directional-potential
system.

Copy of ``ssrs_tpu/potential/direct.py`` apart from imports.
Numerically the reference path (ssrs/movmodel.py:86-128: SuperLU via
scipy.sparse.linalg.spsolve), assembled vectorized instead of with the
reference's per-edge Python loop. It is the port's solver for
``Config.potential_solver='direct'`` and the fallback behind the refined
device solver's residual net: it runs in numpy and scipy on the host, and
the caller moves the float32 result to the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..agents.moves import NEIGHBOR_DELTAS
from .boundary import boundary_nodes

SQRT2 = float(np.sqrt(2.0))

# Cost anchors for the SuperLU solve on this class of system, measured
# by the JAX package on dense-speckle adversarial fields on one host
# core (scripts/exp_fallback_cost.py): (unknowns, wall seconds, peak RSS
# GB).
#   512^2: 4.9 s / 0.94 GB;  1024^2: 41.8 s / 3.4 GB;
#   2048^2: 364 s / 14.7 GB: wall ~ u^1.55, memory ~ u^1.1.
# At 4096^2 (16.8M unknowns) scipy's SuperLU fails outright (the int32
# fill-in indexing limit), so beyond ~8M unknowns this fallback is
# unavailable; the Simulator's size cap
# (Config.potential_fallback_max_unknowns) refuses before trying.
_COST_ANCHOR_UNKNOWNS = 262_144          # 512^2
_COST_ANCHOR_SECONDS = 4.9
_COST_ANCHOR_GB = 0.94
_COST_WALL_EXP = 1.55
_COST_MEM_EXP = 1.1


def fallback_cost_estimate(unknowns: int) -> Tuple[float, float]:
    """(estimated wall seconds, estimated peak GB) of
    :func:`solve_potential_direct` at ``unknowns`` grid cells, from the
    scaling table above. The Simulator's residual-net fallback reads it
    to refuse silently buying an hours-long host solve."""
    ratio = max(unknowns, 1) / _COST_ANCHOR_UNKNOWNS
    return (_COST_ANCHOR_SECONDS * ratio ** _COST_WALL_EXP,
            _COST_ANCHOR_GB * ratio ** _COST_MEM_EXP)


def _edge_arrays(cond: np.ndarray):
    """Vectorized equivalent of the reference's per-node neighbor-list
    assembly: returns COO (row_nodes, col_nodes, weights) in the reference's
    column-major node numbering, including the east-column fac quirk (see
    ssrs_tpu/potential/solver.py docstring)."""
    nrow, ncol = cond.shape
    rows_g, cols_g = np.meshgrid(np.arange(nrow), np.arange(ncol),
                                 indexing='ij')
    node = cols_g * nrow + rows_g
    coo_i, coo_j, coo_w = [], [], []
    for m in range(9):
        if m == 4:
            continue
        dr, dc = int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1])
        valid = ((rows_g + dr >= 0) & (rows_g + dr < nrow) &
                 (cols_g + dc >= 0) & (cols_g + dc < ncol))
        r2 = np.clip(rows_g + dr, 0, nrow - 1)
        c2 = np.clip(cols_g + dc, 0, ncol - 1)
        ca = cond
        cb = cond[r2, c2]
        both = (ca != 0) & (cb != 0)
        with np.errstate(divide='ignore'):
            hm = np.where(both, 2.0 / (1.0 / np.where(ca == 0, 1, ca)
                                       + 1.0 / np.where(cb == 0, 1, cb)),
                          1e-8)
        fac = np.full(cond.shape, SQRT2 if (dr and dc) else 1.0)
        if (dr, dc) == (-1, 0):
            fac[1:nrow - 1, ncol - 1] = SQRT2
        elif (dr, dc) == (-1, -1):
            fac[1:nrow - 1, ncol - 1] = 1.0
        w = hm / fac
        coo_i.append(node[valid])
        coo_j.append((c2 * nrow + r2)[valid])
        coo_w.append(w[valid])
    return (np.concatenate(coo_i), np.concatenate(coo_j),
            np.concatenate(coo_w))


def solve_potential_direct(conductivity: np.ndarray,
                           move_dirn: float) -> np.ndarray:
    """Reference-exact directional potential (float64 direct solve).

    Returns float32 (nrow, ncol), boundary rows clamped to their Dirichlet
    values, matching ssrs/movmodel.py:113-128.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    cond = np.asarray(conductivity, np.float64)
    nrow, ncol = cond.shape
    n = nrow * ncol
    bnodes, bvals = boundary_nodes(move_dirn, (nrow, ncol))

    ci, cj, cw = _edge_arrays(cond)
    g = sp.csr_matrix((cw, (ci, cj)), shape=(n, n))
    rowsum = np.asarray(g.sum(axis=1)).ravel()
    g = sp.diags(1.0 / rowsum) @ g

    inner = np.setdiff1d(np.arange(n), bnodes, assume_unique=True)
    g_inner = g.tocsr()[inner].tocsc()
    a = sp.eye(inner.size, format='csc') - g_inner[:, inner]
    rhs = g_inner[:, bnodes] @ bvals
    x = spla.spsolve(a, rhs)
    if not np.isfinite(x).all():
        # SuperLU signals some failures (e.g. the int32 fill-in limit
        # hit near 4096^2) by printing and returning non-finite output
        raise RuntimeError(
            f'SuperLU direct solve failed at {inner.size} unknowns '
            '(non-finite solution; see docs/DESIGN.md "fallback cost '
            'at scale" for the measured feasibility envelope)')

    full = np.empty(n)
    full[inner] = x
    full[bnodes] = bvals
    # column-major node -> (row, col)
    out = full.reshape(ncol, nrow).T
    return out.astype(np.float32)


def interior_residual(potential: np.ndarray, conductivity: np.ndarray,
                      move_dirn: float) -> float:
    """max |x - P x| over the interior (non-Dirichlet) nodes, in float64,
    of the reference's row-normalized system for the potential ``x``
    (0..1000): how far ``x`` is from solving it. A float32-rounded exact
    answer reads ~6e-5 on the README's 500x600 field."""
    import scipy.sparse as sp

    cond = np.asarray(conductivity, np.float64)
    nrow, ncol = cond.shape
    n = nrow * ncol
    ci, cj, cw = _edge_arrays(cond)
    g = sp.csr_matrix((cw, (ci, cj)), shape=(n, n))
    rowsum = np.asarray(g.sum(axis=1)).ravel()
    # column-major node numbering
    x = np.asarray(potential, np.float64).T.ravel()
    r = x - (g @ x) / rowsum
    inner = np.ones(n, bool)
    inner[boundary_nodes(move_dirn, (nrow, ncol))[0]] = False
    return float(np.abs(r[inner]).max())
