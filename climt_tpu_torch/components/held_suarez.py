"""Held-Suarez (1994) idealized forcing (climt_tpu/components/held_suarez.py).

Newtonian relaxation of temperature toward the analytic equilibrium
Teq(lat, p) and Rayleigh damping of winds below sigma_b, with the standard
HS94 coefficients as defaults.  Pure elementwise tensor arithmetic.
"""

from __future__ import annotations

import torch

from ..core.base_components import TendencyComponent
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device


def held_suarez_forcing(u, v, T, p, ps, latitude,
                        sigma_b, k_f, k_a, k_s, delta_T_y, delta_theta_z,
                        p0, kappa):
    """(du, dv, dT) of the winds, temperature and pressure ``p``, each
    (ncol, nz), with ``ps`` (surface pressure) and ``latitude`` (degrees)
    of shape (ncol,), as JAX takes them (held_suarez.py:20)."""
    lat_rad = torch.deg2rad(latitude)[:, None]
    return _held_suarez_tendencies(
        u, v, T, p, ps[:, None], torch.sin(lat_rad) ** 2,
        torch.cos(lat_rad) ** 2, sigma_b, k_f, k_a, k_s, delta_T_y,
        delta_theta_z, p0, kappa)


def _held_suarez_tendencies(u, v, T, p, ps, sinlat2, coslat2,
                            sigma_b, k_f, k_a, k_s, delta_T_y,
                            delta_theta_z, p0, kappa):
    """``held_suarez_forcing`` with ``ps``, ``sinlat2`` and ``coslat2``
    (sin^2 and cos^2 of latitude) broadcasting against the fields, so
    that the fused model (dycore/compiled.py) passes its grid blocks."""
    sigma = p / ps

    Teq = torch.clamp(
        (315.0 - delta_T_y * sinlat2
         - delta_theta_z * torch.log(p / p0) * coslat2)
        * (p / p0) ** kappa, min=200.0)

    sigma_factor = torch.clamp((sigma - sigma_b) / (1.0 - sigma_b), min=0.0)
    k_t = k_a + (k_s - k_a) * sigma_factor * coslat2 ** 2
    k_v = k_f * sigma_factor

    return -k_v * u, -k_v * v, -k_t * (T - Teq)


class HeldSuarez(TendencyComponent):
    """Held & Suarez (1994) dynamical-core intercomparison forcing.

    Computes on ``device`` (the CUDA card unless the caller asks for
    another; without a card the default raises): ``array_call`` moves its
    raw inputs there and returns tensors there."""

    input_properties = {
        'eastward_wind': {'dims': ['*', 'mid_levels'], 'units': 'm s^-1'},
        'northward_wind': {'dims': ['*', 'mid_levels'], 'units': 'm s^-1'},
        'air_temperature': {'dims': ['*', 'mid_levels'], 'units': 'degK'},
        'air_pressure': {'dims': ['*', 'mid_levels'], 'units': 'Pa'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
    }

    tendency_properties = {
        'eastward_wind': {'units': 'm s^-2'},
        'northward_wind': {'units': 'm s^-2'},
        'air_temperature': {'units': 'degK s^-1'},
    }

    diagnostic_properties = {}

    def __init__(self,
                 sigma_boundary_layer_top=0.7,
                 k_f=1 / 86400.,
                 k_a=1 / 40. / 86400.,
                 k_s=1 / 4. / 86400.,
                 equator_pole_temperature_difference=60,
                 delta_theta_z=10,
                 device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        self._sigma_b = sigma_boundary_layer_top
        self._k_f = k_f
        self._k_a = k_a
        self._k_s = k_s
        self._delta_T_y = equator_pole_temperature_difference
        self._delta_theta_z = delta_theta_z
        super().__init__(**kwargs)

    def array_call(self, raw_state):
        p0 = get_constant('reference_air_pressure', 'Pa')
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/degK')
        rd = get_constant('gas_constant_of_dry_air', 'J/kg/degK')
        u, v, T, p, ps, latitude = (
            as_tensor(raw_state[name], self.device)
            for name in ('eastward_wind', 'northward_wind',
                         'air_temperature', 'air_pressure',
                         'surface_air_pressure', 'latitude'))
        du, dv, dT = held_suarez_forcing(
            u, v, T, p, ps, latitude, self._sigma_b, self._k_f, self._k_a,
            self._k_s, self._delta_T_y, self._delta_theta_z, p0, rd / cpd)
        return ({'eastward_wind': du, 'northward_wind': dv,
                 'air_temperature': dT}, {})
