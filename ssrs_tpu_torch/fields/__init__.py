"""Field computations on the run's device: terrain derivatives,
orographic updrafts, thermal fields and atmospheric scalars; the WTK
sites' interpolation to the grid (``interp.py``)."""

from .atmosphere import (compute_potential_temperature,
                         compute_thermal_updraft, deardoff_velocity_function)
from .terrain import (compute_aspect_degrees, compute_aspect_richdem_degrees,
                      compute_slope_aspect_degrees, compute_slope_degrees,
                      compute_slope_richdem_degrees)
from .thermals import compute_thermals, gaussian_filter, gaussian_kernel1d
from .updraft import (compute_orographic_updraft, get_above_threshold_speed,
                      orographic_updraft_from_dem)

__all__ = ['compute_potential_temperature', 'compute_thermal_updraft',
           'deardoff_velocity_function', 'compute_aspect_degrees',
           'compute_aspect_richdem_degrees', 'compute_slope_aspect_degrees',
           'compute_slope_degrees', 'compute_slope_richdem_degrees',
           'compute_thermals', 'gaussian_filter', 'gaussian_kernel1d',
           'compute_orographic_updraft', 'get_above_threshold_speed',
           'orographic_updraft_from_dem']
