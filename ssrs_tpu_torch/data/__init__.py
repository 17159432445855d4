"""Host-side data layer: CRS, rasters, the offline synthetic terrain."""

from .crs import (get_crs, get_utm_string, transform_bounds,
                  transform_coordinates)
from .geotiff import (get_raster_bounds, get_raster_data, read_geotiff,
                      write_geotiff)
from .raster import get_raster_in_projected_crs, resample_to_grid
from .synthetic import SyntheticTerrain, synthetic_dem_lonlat
from .terrain import Terrain

__all__ = [
    'get_crs', 'get_utm_string', 'transform_bounds',
    'transform_coordinates', 'get_raster_bounds', 'get_raster_data',
    'read_geotiff', 'write_geotiff', 'get_raster_in_projected_crs',
    'resample_to_grid', 'SyntheticTerrain', 'synthetic_dem_lonlat',
    'Terrain',
]
