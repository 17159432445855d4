"""Copy of ``ssrs_tpu/data/wms.py``, unchanged apart from imports.

OGC WMS GetMap client (requests-based; owslib is unavailable).

Reference semantics (ssrs/terrain/wms.py): tile the request so no tile
exceeds ``max_gridsize`` pixels, download each tile with bounded retries,
mosaic tiles into one GeoTIFF. The reference mosaics with rasterio.merge;
here tiles share one resolution and grid so the mosaic is a plain array
paste.

WMS 1.3.0 + EPSG:4326 uses (lat, lon) axis order in BBOX; 1.1.1 uses
(lon, lat) — handled in ``_bbox_param``.
"""

from __future__ import annotations

import io
import os
import time
from typing import List, Tuple

import numpy as np

from .geotiff import read_geotiff, write_geotiff


class WMSError(Exception):
    pass


class WMS:
    """Tiled WMS GetMap downloader (ssrs/terrain/wms.py:12-188)."""

    fmt = 'image/tiff'
    version = '1.3.0'

    def __init__(self, bnds: Tuple[float, float, float, float],
                 crs_str: str, url: str, max_gridsize: int = 2000,
                 max_retries: int = 3):
        if not (bnds[2] > bnds[0] and bnds[3] > bnds[1]):
            raise ValueError(f'WMS: Invalid bounds {bnds}\n')
        self.bnds = bnds
        self.crs_str = crs_str
        self.url = url
        self.max_gridsize = max_gridsize
        self.max_retries = max_retries
        self._capabilities = None  # layer -> set of lowercase CRS strings

    # ---- capabilities ------------------------------------------------------

    def _fetch_capabilities(self) -> dict:
        """GetCapabilities -> {layer name: {crs strings, lowercase}}.

        The reference validates the requested layer and CRS against the
        server's advertised capabilities via owslib at construction
        (ssrs/terrain/wms.py:56-70); here the XML is parsed directly and
        fetched lazily on the first download so offline construction (for
        tile-geometry work) stays possible. WMS Layer elements inherit CRS
        from ancestors per the spec, which the recursion reproduces.
        """
        import requests
        import xml.etree.ElementTree as ET
        resp = requests.get(self.url, params={
            'service': 'WMS', 'request': 'GetCapabilities',
            'version': self.version}, timeout=(4, 60))
        resp.raise_for_status()
        root = ET.fromstring(resp.content)

        def local(tag: str) -> str:
            return tag.rsplit('}', 1)[-1]

        layers: dict = {}

        def walk(el, inherited):
            crs = set(inherited)
            name = None
            for child in el:
                tag = local(child.tag)
                if tag in ('CRS', 'SRS') and child.text:
                    crs.add(child.text.strip().lower())
                elif tag == 'Name' and child.text:
                    name = child.text.strip()
            if name:
                layers[name] = crs
            for child in el:
                if local(child.tag) == 'Layer':
                    walk(child, crs)

        for cap in (el for el in root.iter()
                    if local(el.tag) == 'Capability'):
            for child in cap:
                if local(child.tag) == 'Layer':
                    walk(child, set())
        return layers

    def validate_layer(self, layer: str) -> None:
        """Check the requested layer exists and supports this client's CRS
        per the server's GetCapabilities (ssrs/terrain/wms.py:56-70)."""
        if self._capabilities is None:
            try:
                self._capabilities = self._fetch_capabilities()
            except Exception as exc:
                raise WMSError(
                    f'WMS: GetCapabilities request to {self.url} failed '
                    f'({exc})') from exc
        if layer not in self._capabilities:
            raise ValueError(
                f'WMS: layer {layer!r} is not advertised by this server; '
                'available: ' + ', '.join(sorted(self._capabilities)))
        if self.crs_str.lower() not in self._capabilities[layer]:
            raise ValueError(
                f'WMS: layer {layer!r} does not support CRS '
                f'{self.crs_str}; advertised: '
                + ', '.join(sorted(self._capabilities[layer])))

    def _bbox_param(self, bnds) -> str:
        if self.version == '1.3.0' and self.crs_str.upper() in (
                'EPSG:4326', 'EPSG:4269'):
            return f'{bnds[1]},{bnds[0]},{bnds[3]},{bnds[2]}'
        return f'{bnds[0]},{bnds[1]},{bnds[2]},{bnds[3]}'

    def segment_region_into_tiles(self, res: float
                                  ) -> List[Tuple[float, float, float, float]]:
        """Tile bounds so each tile is <= max_gridsize px
        (ssrs/terrain/wms.py:72-88)."""
        width = int(round((self.bnds[2] - self.bnds[0]) / res))
        height = int(round((self.bnds[3] - self.bnds[1]) / res))
        count_x = int(width // self.max_gridsize) + 1
        count_y = int(height // self.max_gridsize) + 1
        xbnds = np.linspace(self.bnds[0], self.bnds[2], count_x + 1)
        ybnds = np.linspace(self.bnds[1], self.bnds[3], count_y + 1)
        return [(xbnds[i], ybnds[j], xbnds[i + 1], ybnds[j + 1])
                for i in range(count_x) for j in range(count_y)]

    def _getmap(self, layer: str, bnds, width: int, height: int) -> bytes:
        import requests
        params = {
            'service': 'WMS', 'request': 'GetMap',
            'version': self.version, 'layers': layer,
            ('crs' if self.version == '1.3.0' else 'srs'): self.crs_str,
            'bbox': self._bbox_param(bnds),
            'width': str(width), 'height': str(height),
            'format': self.fmt,
        }
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                # (connect, read) timeout: fail fast when unreachable
                resp = requests.get(self.url, params=params,
                                    timeout=(4, 120))
                resp.raise_for_status()
                if 'xml' in resp.headers.get('Content-Type', ''):
                    raise WMSError(f'WMS service exception: '
                                   f'{resp.content[:500]!r}')
                return resp.content
            except Exception as exc:  # bounded retry (wms.py:105-125)
                last = exc
                conn_err = getattr(requests.exceptions, 'ConnectionError')
                conn_to = getattr(requests.exceptions, 'ConnectTimeout')
                if isinstance(exc, (conn_err, conn_to)):
                    break  # unreachable host: retrying won't help
                time.sleep(min(2 ** attempt, 8))
        raise WMSError(f'WMS: GetMap gave up after {self.max_retries + 1} '
                       f'attempts ({last})')

    def download_raster(self, layer: str, res: float, fpath: str) -> None:
        """Download, tile by tile, and mosaic into ``fpath``
        (ssrs/terrain/wms.py:167-183)."""
        max_res = min(self.bnds[2] - self.bnds[0],
                      self.bnds[3] - self.bnds[1])
        if not 0. < res < max_res:
            raise ValueError(f'WMS: Invalid resolution {res} for bnds '
                             f'{self.bnds} in crs {self.crs_str}\n')
        self.validate_layer(layer)
        tiles = self.segment_region_into_tiles(res)
        arrays = []
        for bnds in tiles:
            width = int(round((bnds[2] - bnds[0]) / res))
            height = int(round((bnds[3] - bnds[1]) / res))
            raw = self._getmap(layer, bnds, width, height)
            info = read_geotiff(io.BytesIO(raw))
            arrays.append((bnds, info.data))
        self._mosaic(arrays, res, fpath)

    def _mosaic(self, tiles, res: float, fpath: str) -> None:
        width = int(round((self.bnds[2] - self.bnds[0]) / res))
        height = int(round((self.bnds[3] - self.bnds[1]) / res))
        out = np.zeros((height, width), np.float32)
        for bnds, data in tiles:
            col0 = int(round((bnds[0] - self.bnds[0]) / res))
            row0 = int(round((self.bnds[3] - bnds[3]) / res))
            h, w = data.shape
            out[row0:row0 + h, col0:col0 + w] = data
        os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
        epsg = int(self.crs_str.split(':')[1]) \
            if ':' in self.crs_str else 4326
        write_geotiff(fpath, out, self.bnds, epsg=epsg)
