"""Copy of ``ssrs_tpu/data/threedep.py``, unchanged apart from imports.

USGS 3DEP elevation layers over WMS (ssrs/terrain/threedep.py)."""

from __future__ import annotations

from typing import Tuple

from .wms import WMS


class ThreeDEP(WMS):
    """3DEP WMS client (ssrs/terrain/threedep.py:8-63)."""

    wms_url = ('https://elevation.nationalmap.gov/arcgis/services/'
               '3DEPElevation/ImageServer/WMSServer')
    valid_layers = (
        'DEM',
        'Hillshade Gray',
        'Aspect Degrees',
        'Aspect Map',
        'GreyHillshade_elevationFill',
        'Hillshade Multidirectional',
        'Slope Map',
        'Slope Degrees',
        'Hillshade Elevation Tinted',
        'Height Ellipsoidal',
        'Contour 25',
        'Contour Smoothed 25',
    )
    crs_str = 'EPSG:4326'

    def __init__(self, layer: str,
                 bnds: Tuple[float, float, float, float],
                 fpath: str,
                 res: float = 1. / 3600. / 3.):
        if layer not in self.valid_layers:
            raise ValueError(
                f'ThreeDEP:{layer} not a valid layer!\nOptions:'
                + '\n' + '\n'.join(self.valid_layers) + '\n')
        # the service name for the DEM layer is '3DEPElevation:None'
        service_layer = 'None' if layer == 'DEM' else layer
        self.layer_name = f'3DEPElevation:{service_layer}'
        self.res = res
        self.fpath = fpath
        super().__init__(bnds, self.crs_str, self.wms_url, 2000)

    def download(self) -> None:
        self.download_raster(self.layer_name, self.res, self.fpath)
