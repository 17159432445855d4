"""Directional potential: boundary conditions, the refined device solver
and the host float64 direct solve."""

from .boundary import boundary_masks, boundary_nodes
from .direct import fallback_cost_estimate, solve_potential_direct
from .lap import solve_potential_refined, weight_planes
from .solver import transition_planes

__all__ = ['boundary_masks', 'boundary_nodes', 'fallback_cost_estimate',
           'solve_potential_direct', 'solve_potential_refined',
           'transition_planes', 'weight_planes']
