"""Field computations on the run's device: terrain derivatives and
orographic updrafts."""

from .terrain import (compute_aspect_degrees, compute_slope_aspect_degrees,
                      compute_slope_degrees)
from .updraft import (compute_orographic_updraft, get_above_threshold_speed,
                      orographic_updraft_from_dem)

__all__ = ['compute_aspect_degrees', 'compute_slope_aspect_degrees',
           'compute_slope_degrees', 'compute_orographic_updraft',
           'get_above_threshold_speed', 'orographic_updraft_from_dem']
