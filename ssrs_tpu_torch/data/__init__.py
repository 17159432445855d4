"""Host-side data layer: CRS, rasters, terrain/wind/turbine clients."""

from .crs import (get_crs, get_utm_string, transform_bounds,
                  transform_coordinates)
from .geotiff import (get_raster_bounds, get_raster_data, read_geotiff,
                      write_geotiff)
from .raster import get_raster_in_projected_crs, resample_to_grid
from .srtm import SRTM
from .synthetic import SyntheticTerrain, synthetic_dem_lonlat
from .table import Table, read_csv
from .terrain import Terrain
from .threedep import ThreeDEP
from .turbines import TurbinesUSWTB
from .wms import WMS
from .wtk import WTK
from .wtksource import WtkSource, create_hscfg_file

__all__ = [
    'get_crs', 'get_utm_string', 'transform_bounds',
    'transform_coordinates', 'get_raster_bounds', 'get_raster_data',
    'read_geotiff', 'write_geotiff', 'get_raster_in_projected_crs',
    'resample_to_grid', 'SRTM', 'SyntheticTerrain', 'synthetic_dem_lonlat',
    'Table', 'read_csv', 'Terrain', 'ThreeDEP', 'TurbinesUSWTB', 'WMS',
    'WTK', 'WtkSource', 'create_hscfg_file',
]
