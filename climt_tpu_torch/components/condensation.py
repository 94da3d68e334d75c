"""Grid-scale condensation of supersaturated water
(climt_tpu/components/condensation.py).

Condense q > q_sat with the latent-heat feedback factor
1/(1 + L/Cp dqsat/dT); all condensate falls at once as precipitation (the
vertical mass integral).  Elementwise over (level, column) on ``device``.
"""

from __future__ import annotations

import torch

from ..core.base_components import Stepper
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import bolton_dqsat_dT, bolton_q_sat, resolve_device


def condense(T, q, p, p_interface, cpd, lv, rd, rh2o, g, rhow):
    """(new T, new q, precipitation) (:21)."""
    q_sat = bolton_q_sat(T, p, rd, rh2o)
    dqsat_dT = bolton_dqsat_dT(T, lv, rh2o, q_sat)
    condensed = torch.where(
        q > q_sat, (q - q_sat) / (1.0 + (lv / cpd) * dqsat_dT), 0.0)
    new_q = q - condensed
    new_T = T + (lv / cpd) * condensed
    # liquid-water-equivalent precipitation depth per layer: dp/(g rho_w)
    mass = (p_interface[1:] - p_interface[:-1]) / (g * rhow)
    precipitation = torch.sum(condensed * mass, dim=0)
    return new_T, new_q, precipitation


class GridScaleCondensation(Stepper):
    """Condense supersaturated water at the grid scale (:36), on
    ``device`` (the CUDA card unless the caller asks for another)."""

    input_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'Pa'},
    }

    diagnostic_properties = {
        'precipitation_amount': {'dims': ['*'], 'units': 'kg m^-2'},
    }

    output_properties = {
        'air_temperature': {'units': 'degK'},
        'specific_humidity': {'units': 'kg/kg'},
    }

    def __init__(self, device='cuda', **kwargs):
        self.device = resolve_device(device)
        super().__init__(**kwargs)

    def array_call(self, raw_state, timestep):
        new_T, new_q, precipitation = condense(
            *(as_tensor(raw_state[name], self.device) for name in (
                'air_temperature', 'specific_humidity', 'air_pressure',
                'air_pressure_on_interface_levels')),
            get_constant('heat_capacity_of_dry_air_at_constant_pressure',
                         'J/kg/degK'),
            get_constant('latent_heat_of_condensation', 'J/kg'),
            get_constant('gas_constant_of_dry_air', 'J/kg/degK'),
            get_constant('gas_constant_of_vapor_phase', 'J/kg/degK'),
            get_constant('gravitational_acceleration', 'm/s^2'),
            get_constant('density_of_liquid_phase', 'kg/m^3'))
        return ({'precipitation_amount': precipitation},
                {'air_temperature': new_T, 'specific_humidity': new_q})
