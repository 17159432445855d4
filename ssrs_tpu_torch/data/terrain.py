"""Terrain layer acquisition with file-granular caching.

``ssrs_tpu/data/terrain.py`` with only the offline ``SYNTHETIC`` source:
the same cache file name and the same bounds-containment check, so a
cached DEM written by either package serves the other. The 3DEP and
SRTM sources are not ported yet (ROADMAP); offline, the JAX package's
3DEP -> SRTM -> synthetic chain ends at this same synthetic file."""

from __future__ import annotations

import os
from typing import List, Tuple, Union

from .geotiff import read_geotiff
from .synthetic import SyntheticTerrain


class Terrain:
    """Terrain layers for a lon/lat-bounded region
    (ssrs/terrain/terrain.py:12-94)."""

    valid_layers = SyntheticTerrain.valid_layers

    def __init__(self, lonlat_bounds: Tuple[float, float, float, float],
                 out_dir: str, print_verbose: bool = True):
        if print_verbose:
            print(f'Terrain: Bounds set to '
                  f'{[round(ix, 2) for ix in lonlat_bounds]}')
        self.lonlat_bounds = lonlat_bounds
        self.out_dir = out_dir
        self.print_verbose = print_verbose
        os.makedirs(self.out_dir, exist_ok=True)

    def get_raster_fpath(self, lyr: str) -> str:
        fname = f'{lyr.lower().replace(" ", "_")}.tif'
        return os.path.join(self.out_dir, fname)

    def download(self, layers: Union[List[str], str],
                 pad: float = 0.01) -> None:
        layers = [layers] if isinstance(layers, str) else layers
        for layer in layers:
            self.validate_layer_name(layer)
            fpath = self.get_raster_fpath(layer)
            pad_bnds = [v + p for v, p in zip(
                self.lonlat_bounds, (-pad, -pad, pad, pad))]
            try:
                self.validate_saved_layer_data(layer)
            except FileNotFoundError:
                if self.print_verbose:
                    print('Terrain: Generating synthetic DEM..')
                SyntheticTerrain(layer, pad_bnds, fpath).download()
            else:
                if self.print_verbose:
                    print(f'Terrain: Found saved raster data for {layer}')

    def validate_layer_name(self, layer: str) -> None:
        if layer not in self.valid_layers:
            raise NotImplementedError(
                f'Terrain layer {layer!r}: the port has only the offline '
                "'SYNTHETIC' source; 3DEP/SRTM wait (ROADMAP.md, "
                'modules still to port)')

    def validate_saved_layer_data(self, layer: str) -> None:
        """Bounds-containment cache validation
        (ssrs/terrain/terrain.py:81-94)."""
        try:
            info = read_geotiff(self.get_raster_fpath(layer))
            sb = info.bounds
            ok = (sb[0] <= self.lonlat_bounds[0] <= sb[2]
                  and sb[1] <= self.lonlat_bounds[1] <= sb[3]
                  and sb[0] <= self.lonlat_bounds[2] <= sb[2]
                  and sb[1] <= self.lonlat_bounds[3] <= sb[3])
            if not ok:
                raise FileNotFoundError
        except Exception:
            raise FileNotFoundError from None
