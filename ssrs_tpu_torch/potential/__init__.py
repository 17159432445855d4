"""Directional potential: boundary conditions and the host float64
direct solve."""

from .boundary import boundary_masks, boundary_nodes
from .direct import solve_potential_direct

__all__ = ['boundary_masks', 'boundary_nodes', 'solve_potential_direct']
