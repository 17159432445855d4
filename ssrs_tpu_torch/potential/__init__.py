"""Directional potential: boundary conditions, the refined device solver
(one field, or a batch of cases), the legacy multigrid and the host
float64 direct solve."""

from .boundary import boundary_masks, boundary_nodes
from .direct import fallback_cost_estimate, solve_potential_direct
from .lap import (solve_potential_refined, solve_potential_refined_batch,
                  weight_planes)
from .multigrid import solve_potential_mg
from .solver import (solve_potential, solve_potential_for_direction,
                     transition_planes)

__all__ = ['boundary_masks', 'boundary_nodes', 'fallback_cost_estimate',
           'solve_potential', 'solve_potential_direct',
           'solve_potential_for_direction', 'solve_potential_mg',
           'solve_potential_refined', 'solve_potential_refined_batch',
           'transition_planes', 'weight_planes']
