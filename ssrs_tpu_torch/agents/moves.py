"""Static move geometry, direction-restriction tables and directional
priors.

Copy of the numpy tables of ``ssrs_tpu/agents/moves.py``, unchanged
apart from imports (the JAX-only ``move_probability_cascade`` is left
out: the port's cascade lives in ``agents/fused_step.py``). They
reproduce the reference's per-step movement semantics
(ssrs/movmodel.py:131-141, 185-257):

- Moves are indexed 0..8 over the row-major flattened 3x3 neighborhood;
  move index ``m`` maps to ``(dr, dc) = (m // 3 - 1, m % 3 - 1)`` and the
  center (no move) is index 4, matching ``neighbour_deltas``
  (ssrs/movmodel.py:132-141).
- ``restriction_table()`` tabulates ``get_track_restrictions(dr, dc)``
  (ssrs/movmodel.py:185-202) for all 9 previous moves, including its
  operator-precedence quirk ``abs(dr + dc % 2)`` (i.e. ``abs(dr + (dc % 2))``
  with Python's nonnegative modulo).
- ``directional_probs()`` is ``get_directional_probs``
  (ssrs/movmodel.py:247-257) verbatim.

Deliberate deviation (documented): the reference's
``directions[-memory_parameter:]`` with ``memory_parameter == 0`` slices the
*entire* history (a Python quirk); here ``track_dirn_restrict == 0`` means
"no direction-memory restriction".
"""

from __future__ import annotations

import numpy as np

# (dr, dc) for each of the 9 move indices (row-major 3x3), center = 4.
NEIGHBOR_DELTAS = np.array(
    [[r - 1, c - 1] for r in range(3) for c in range(3)], dtype=np.int32)

# 1/||delta||, 0 at the center (ssrs/movmodel.py:133-141).
_norms = np.linalg.norm(NEIGHBOR_DELTAS.astype(np.float64), axis=1)
NEIGHBOR_NORMS_INV = np.where(_norms > 0, 1.0 / np.where(_norms == 0, 1, _norms),
                              0.0).astype(np.float32)

# 1 everywhere except the center cell; the implicit base mask
# get_track_restrictions(0, 0) (ssrs/movmodel.py:199-201).
CENTER_ZERO = np.ones(9, dtype=np.float32)
CENTER_ZERO[4] = 0.0


def track_restrictions(dr: int, dc: int) -> np.ndarray:
    """Reference ``get_track_restrictions`` (ssrs/movmodel.py:185-202)."""
    a_mat = np.zeros((3, 3), dtype=int)
    dr_mat = np.zeros((3, 3), dtype=int)
    dc_mat = np.zeros((3, 3), dtype=int)
    if abs(dr + dc % 2) == 1:  # sic: abs(dr + (dc % 2))
        if dr == 0:
            a_mat[:, dc + 1] = 1
        else:
            a_mat[dr + 1, :] = 1
    else:
        dr_mat[(dr + 1, 1), :] = 1
        dc_mat[:, (1, dc + 1)] = 1
        a_mat = np.logical_and(dr_mat, dc_mat).astype(int)
    if dr == 0 and dc == 0:
        a_mat[:, :] = 1
    a_mat[1, 1] = 0
    return a_mat.flatten()


def restriction_table() -> np.ndarray:
    """(9, 9) float32 table: row m = allowed-move mask after previous move
    m. Row 4 (no previous move) allows everything but the center."""
    table = np.stack([track_restrictions(m // 3 - 1, m % 3 - 1)
                      for m in range(9)])
    return table.astype(np.float32)


def directional_probs(move_dirn_deg: float) -> np.ndarray:
    """Reference ``get_directional_probs`` (ssrs/movmodel.py:247-257);
    ``move_dirn_deg`` in degrees clockwise from north. Returns the
    flattened 9-vector prior (center 0)."""
    theta = float(move_dirn_deg) * np.pi / 180.
    dir_mat = np.zeros((3, 3))
    dir_mat[0, :] = [np.cos(np.pi / 4 + theta), np.cos(theta),
                     np.cos(7 * np.pi / 4 + theta)]
    dir_mat[1, :] = [np.cos(np.pi / 2 + theta), 0,
                     np.cos(3 * np.pi / 2 + theta)]
    dir_mat[2, :] = [np.cos(3 * np.pi / 4 + theta), np.cos(np.pi + theta),
                     np.cos(5 * np.pi / 4 + theta)]
    dir_mat[dir_mat < 0.01] = 0.
    return np.flipud(dir_mat.clip(min=0.)).flatten().astype(np.float32)
