"""Thermal and atmospheric scalar fields.

The PyTorch counterpart of ``ssrs_tpu/fields/atmosphere.py`` (reference
semantics: ``deardoff_velocity_function``, ssrs/layers.py:25-37;
``compute_potential_temperature``, ssrs/layers.py:40-48;
``compute_thermal_updraft``, ssrs/layers.py:51-60). All are elementwise,
in float32 on the device their inputs lie on (a numpy array on the CPU).
"""

from __future__ import annotations

import torch

from .terrain import _as_f32


def deardoff_velocity_function(pot_temperature, blayer_height,
                               surface_heat_flux,
                               min_updraft_val: float = 1e-5) -> torch.Tensor:
    """Deardoff convective velocity scale (ssrs/layers.py:25-37)."""
    fac = 9.8 / 1216.  # to produce kinematic entity
    pot_temp_kelvin = _as_f32(pot_temperature) + 273.15
    pos_heat_flux = torch.clamp(_as_f32(surface_heat_flux), min=0.)
    mod_blheight = torch.clamp(_as_f32(blayer_height), min=100.)
    val = (fac * mod_blheight * pos_heat_flux / pot_temp_kelvin) ** (1. / 3.)
    return torch.clamp(val, min=min_updraft_val)


def compute_potential_temperature(pressure, temperature) -> torch.Tensor:
    """Potential temperature in Celsius (ssrs/layers.py:40-48)."""
    temp_k = _as_f32(temperature) + 273.15
    ref_pressure = 1e5
    return temp_k * (ref_pressure / _as_f32(pressure)) ** 0.2857 - 273.15


def compute_thermal_updraft(zmat, deardoff_vel, blayer_height,
                            min_updraft_val: float = 1e-5) -> torch.Tensor:
    """Thermal updraft at height z from the z/zi profile
    (ssrs/layers.py:51-60)."""
    zbyzi = torch.clamp(_as_f32(zmat) / _as_f32(blayer_height), min=0.,
                        max=1.)
    emat = 0.85 * zbyzi ** (1. / 3.) * (1.3 - zbyzi)
    return torch.clamp(_as_f32(deardoff_vel) * emat, min=min_updraft_val)
