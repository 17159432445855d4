"""Copy of ``ssrs_tpu/potential/boundary.py``, unchanged apart from imports.

Directed boundary conditions for the directional-potential solve.

Reference semantics: ``MovModel.get_boundary_nodes``
(ssrs/movmodel.py:21-57): the perimeter is split into low-potential (0) and
high-potential (1000) node sets by the movement quadrant; the split point of
the concatenated node list is ``size // 2`` *by position*, which for
non-axis-aligned directions does not exactly coincide with the low/high set
boundary — a reference quirk reproduced here by construction (we build the
same concatenated list). Node index ``i`` maps to ``(row, col) =
(i % nrow, i // nrow)`` (column-major, ssrs/movmodel.py:102-103,127).

Output is mask form for the device solver: a boolean Dirichlet mask and a
value field over the (nrow, ncol) grid.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def boundary_nodes(move_dirn: float,
                   grid_shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Verbatim-logic port of ``get_boundary_nodes``; returns
    (node indices (column-major), potentials)."""
    nrow, ncol = grid_shape
    north = np.array([nrow * (x + 1) - 1 for x in range(ncol)])
    south = np.array([nrow * x for x in range(ncol)])
    west = np.array(list(range(1, nrow - 1)))
    east = np.array([(ncol - 1) * nrow + x for x in range(1, nrow - 1)])
    mov_angle = move_dirn % 90.
    mov_quad = (move_dirn % 360) // 90.
    col_len = round(ncol * mov_angle / 90.)
    row_len = round(nrow * mov_angle / 90.)
    if mov_quad == 0:
        low = np.concatenate((north[col_len:], east[nrow - row_len:]))
        high = np.concatenate((south[:ncol - col_len], west[:row_len]))
    elif mov_quad == 1:
        low = np.concatenate((south[ncol - col_len:], east[:nrow - row_len]))
        high = np.concatenate((north[:col_len], west[row_len:]))
    elif mov_quad == 2:
        low = np.concatenate((south[:ncol - col_len], west[:row_len]))
        high = np.concatenate((north[col_len:], east[nrow - row_len:]))
    else:  # mov_quad == 3
        high = np.concatenate((south[ncol - col_len:], east[:nrow - row_len]))
        low = np.concatenate((north[:col_len], west[row_len:]))
    nodes = np.concatenate((low, high)).astype(np.int64)
    potential = np.zeros(nodes.size)
    potential[nodes.size // 2:] = 1000.
    return nodes, potential


def boundary_masks(move_dirn: float,
                   grid_shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(bmask bool (nrow, ncol), bvals float32 (nrow, ncol)) for the device
    solver. Cells not in the Dirichlet set have bval 0 and bmask False."""
    nrow, ncol = grid_shape
    nodes, pots = boundary_nodes(move_dirn, grid_shape)
    bmask = np.zeros((nrow, ncol), dtype=bool)
    bvals = np.zeros((nrow, ncol), dtype=np.float32)
    rows = nodes % nrow
    cols = nodes // nrow
    bmask[rows, cols] = True
    bvals[rows, cols] = pots
    return bmask, bvals
