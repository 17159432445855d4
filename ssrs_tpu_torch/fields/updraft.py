"""Orographic updraft and usable-updraft threshold.

The PyTorch counterpart of ``ssrs_tpu/fields/updraft.py``:

- ``compute_orographic_updraft`` (ssrs/layers.py:11-22):
  w = max(min_val, speed * sin(slope) * max(0, cos(aspect - dirn)));
- ``get_above_threshold_speed`` (ssrs/layers.py:171-185): a smooth blend
  below the threshold.

All angles in degrees, matching the reference; float32 arithmetic.
"""

from __future__ import annotations

import math

import torch

from .terrain import compute_slope_aspect_degrees, from_numpy

DEG2RAD = math.pi / 180.


def compute_orographic_updraft(wspeed, wdirn, slope, aspect,
                               min_updraft_val: float = 0.) -> torch.Tensor:
    """Brandes-Ombalski orographic updraft (ssrs/layers.py:11-22)."""
    wspeed, wdirn, slope, aspect = map(from_numpy,
                                       (wspeed, wdirn, slope, aspect))
    aspect_diff = torch.clamp(torch.cos((aspect - wdirn) * DEG2RAD), min=0.)
    wval = wspeed * torch.sin(slope * DEG2RAD) * aspect_diff
    return torch.clamp(wval, min=min_updraft_val)


def get_above_threshold_speed(in_array: torch.Tensor,
                              threshold: float) -> torch.Tensor:
    """Usable-updraft transform (ssrs/layers.py:171-185):

        w <= 1e-2          -> 0
        1e-2 < w <= thresh -> thresh * (exp((w/thresh)^5) - 1) / (e - 1)
        w > thresh         -> w
    """
    in_array = from_numpy(in_array)
    thr = torch.tensor(threshold, dtype=in_array.dtype,
                       device=in_array.device)
    x = in_array / thr
    x4 = (x * x) * (x * x)
    blend = thr * (torch.exp(x * x4) - 1.) / (math.e - 1.)
    out = torch.where(in_array > thr, in_array, blend)
    return torch.where(in_array > 1e-2, out, torch.zeros_like(out))


def orographic_updraft_from_dem(z_mat, res: float, wspeed, wdirn,
                                min_updraft_val: float = 0.
                                ) -> torch.Tensor:
    """DEM -> (slope, aspect) -> orographic updraft."""
    slope, aspect = compute_slope_aspect_degrees(z_mat, res)
    return compute_orographic_updraft(wspeed, wdirn, slope, aspect,
                                      min_updraft_val)
