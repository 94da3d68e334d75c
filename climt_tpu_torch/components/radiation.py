"""Grey-gas longwave radiation and the Frierson-06 optical depth
(climt_tpu/components/radiation.py).

- ``GrayLongwaveRadiation``: two-sweep grey radiative transfer over the
  interfaces, F_{k+1} = F_k e^{-dtau} + sigma T^4 (1 - e^{-dtau}) upward
  from the surface and the mirror recurrence downward from the top;
  heating rate g/Cp d(F_net)/dp.
- ``Frierson06LongwaveOpticalDepth``: tau(lat, sigma) = tau0(lat) (1 -
  (f_l sigma + (1 - f_l) sigma^4)), tau0 = tau0e + (tau0p - tau0e)
  sin^2(lat).

Both compute on their ``device`` (the CUDA card unless the caller asks
for another); the sweeps are Python loops over levels.
"""

from __future__ import annotations

import math

import torch

from ..core.base_components import DiagnosticComponent, TendencyComponent
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device


def _sweep(flux, trans, source, levels):
    """flux <- flux * trans[k] + source[k] over ``levels``; returns the
    flux after each."""
    out = []
    for k in levels:
        flux = flux * trans[k] + source[k]
        out.append(flux)
    return out


def _layer_terms(T, tau, sigma_sb):
    """Each layer's transmission e^{-dtau} and emission sigma T^4 (1 -
    e^{-dtau})."""
    trans = torch.exp(-(tau[1:] - tau[:-1]))
    return trans, sigma_sb * T ** 4 * (1.0 - trans)


def upward_longwave_flux(T, T_surface, tau, sigma_sb):
    """Upward grey LW flux on interfaces (level axis first, bottom first)
    (radiation.py:27)."""
    trans, source = _layer_terms(T, tau, sigma_sb)
    f0 = sigma_sb * T_surface ** 4
    return torch.stack([f0] + _sweep(f0, trans, source, range(T.shape[0])))


def downward_longwave_flux(T, tau, sigma_sb):
    """Downward grey LW flux on interfaces, zero at the top of the
    atmosphere (radiation.py:43)."""
    trans, source = _layer_terms(T, tau, sigma_sb)
    top = torch.zeros_like(T[0])
    down = _sweep(top, trans, source, range(T.shape[0] - 1, -1, -1))
    return torch.stack(down[::-1] + [top])


def gray_longwave_fluxes(T, p_interface, T_surface, tau, sigma_sb, g, cpd):
    """(downward, upward, net, tendency): fluxes on the interfaces
    (bottom first), heating in K/s on the mid levels (radiation.py:60)."""
    upward = upward_longwave_flux(T, T_surface, tau, sigma_sb)
    downward = downward_longwave_flux(T, tau, sigma_sb)
    net = upward - downward
    tendency = (g / cpd) * (net[1:] - net[:-1]) / (
        p_interface[1:] - p_interface[:-1])
    return downward, upward, net, tendency


class GrayLongwaveRadiation(TendencyComponent):

    input_properties = {
        'longwave_optical_depth_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'dimensionless',
            'alias': 'tau',
        },
        'air_temperature': {
            'dims': ['mid_levels', '*'],
            'units': 'degK',
            'alias': 'sl',
        },
        'surface_temperature': {
            'dims': ['*'],
            'units': 'degK',
            'alias': 'T_surface',
        },
        'air_pressure': {
            'dims': ['mid_levels', '*'],
            'units': 'Pa',
            'alias': 'p',
        },
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'Pa',
            'alias': 'p_interface',
        },
    }

    diagnostic_properties = {
        'downwelling_longwave_flux_in_air': {
            'dims': ['interface_levels', '*'],
            'units': 'W m^-2',
            'alias': 'lw_down',
        },
        'upwelling_longwave_flux_in_air': {
            'dims': ['interface_levels', '*'],
            'units': 'W m^-2',
            'alias': 'lw_up',
        },
        'air_temperature_tendency_from_longwave': {
            'dims': ['mid_levels', '*'],
            'units': 'degK day^-1',
        },
    }

    tendency_properties = {
        'air_temperature': {'units': 'degK s^-1'},
    }

    def __init__(self, device='cuda', **kwargs):
        self.device = resolve_device(device)
        super().__init__(**kwargs)

    def array_call(self, state):
        downward, upward, _, tendency = gray_longwave_fluxes(
            *(as_tensor(state[name], self.device)
              for name in ('sl', 'p_interface', 'T_surface', 'tau')),
            get_constant('stefan_boltzmann_constant', 'W/m^2/K^4'),
            get_constant('gravitational_acceleration', 'm/s^2'),
            get_constant('heat_capacity_of_dry_air_at_constant_pressure',
                         'J/kg/K'))
        diagnostics = {
            'lw_down': downward,
            'lw_up': upward,
            'air_temperature_tendency_from_longwave': tendency * 86400.,
        }
        return {'sl': tendency}, diagnostics


def frierson_tau(latitude_deg, sigma, tau0e, tau0p, fl):
    """Frierson et al. (2006) grey optical depth profile (:139)."""
    tau0 = tau0e + (tau0p - tau0e) * torch.sin(
        latitude_deg * math.pi / 180.0) ** 2
    return tau0 * (1.0 - (fl * sigma + (1.0 - fl) * sigma ** 4))


class Frierson06LongwaveOpticalDepth(DiagnosticComponent):

    input_properties = {
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'Pa',
        },
        'surface_air_pressure': {
            'dims': ['*'],
            'units': 'Pa',
        },
        'latitude': {
            'dims': ['*'],
            'units': 'degrees_N',
        },
    }

    diagnostic_properties = {
        'longwave_optical_depth_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'dimensionless',
        },
    }

    def __init__(self, linear_optical_depth_parameter=0.1,
                 longwave_optical_depth_at_equator=6,
                 longwave_optical_depth_at_poles=1.5, device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        self._fl = linear_optical_depth_parameter
        self._tau0e = longwave_optical_depth_at_equator
        self._tau0p = longwave_optical_depth_at_poles
        super().__init__(**kwargs)

    def array_call(self, state):
        def a(name):
            return as_tensor(state[name], self.device)

        sigma = (a('air_pressure_on_interface_levels')
                 / a('surface_air_pressure')[None, :])
        return {
            'longwave_optical_depth_on_interface_levels': frierson_tau(
                a('latitude'), sigma, self._tau0e, self._tau0p, self._fl),
        }
