"""Conservative dry convective adjustment
(climt_tpu/components/dry_convection.py).

Sweep levels from the model top downward; at each level find the highest
layer such that the running mass-weighted mean of the moisture-weighted
potential temperature theta_q exceeds the environment above, and mix
specific humidity (mass-weighted mean) and enthalpy (along the dry
adiabat with moisture-dependent Cp and R) over that slab.  JAX's
``fori_loop`` over levels (:52-93) is a Python loop over nz here, with the
same masked ``cumsum`` over the level axis for all columns at once.
theta_q comes from the initial profile, as in JAX; mixing reads the
running state.
"""

from __future__ import annotations

import torch

from ..core.base_components import Stepper
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device


def _heat_capacity(q, cpd, cvap):
    return cpd * (1.0 - q) + cvap * q


def _gas_constant(q, rd, rv):
    return rd * (1.0 - q) + rv * q


def dry_convective_adjustment(T, q, p, p_int, cpd, cvap, rd, rv, p_ref):
    """Adjust (T, q) of shape (nz, ncol); level 0 is the lowest layer
    (:40)."""
    nz = T.shape[0]
    k_idx = torch.arange(nz, device=T.device)[:, None]

    dp = p_int[:-1] - p_int[1:]
    rd_cp0 = _gas_constant(q, rd, rv) / _heat_capacity(q, cpd, cvap)
    theta = T * (p_ref / p) ** rd_cp0
    theta_q = theta * (1.0 + q * rv / rd - q)

    for i in range(nz):
        level = nz - 1 - i
        above = k_idx >= level
        csum = torch.cumsum(torch.where(above, theta_q, 0.0), dim=0)
        count = (k_idx - level + 1).to(T.dtype)
        theta_avg = csum / torch.clamp(count, min=1.0)
        # instability: mean over [level, k] exceeds theta_q at k, for k>level
        unstable = (theta_avg > theta_q) & (k_idx > level)
        any_unstable = torch.any(unstable, dim=0)
        k_last = torch.amax(torch.where(unstable, k_idx, -1), dim=0)
        # mixing range [level, stable_level); at the surface at least one
        # layer mixes
        if level == 0:
            stable_level = torch.where(k_last <= level, level + 1, k_last)
        else:
            stable_level = k_last
        do_mix = any_unstable & (stable_level > level)

        in_range = (k_idx >= level) & (k_idx < stable_level)
        w = torch.where(in_range, dp, 0.0)

        cp_old = _heat_capacity(q, cpd, cvap)
        integral_enthalpy = torch.sum(cp_old * T * w, dim=0)
        p_top_minus_bottom = torch.sum(w, dim=0)
        mean_q = torch.sum(q * w, dim=0) / torch.clamp(p_top_minus_bottom,
                                                       min=1e-30)

        rdcp_conv = (_gas_constant(mean_q, rd, rv)
                     / _heat_capacity(mean_q, cpd, cvap))
        theta_coeff = (p / p_ref) ** rdcp_conv[None, :]
        integral_theta_den = torch.sum(cp_old * theta_coeff * w, dim=0)
        mean_theta = integral_enthalpy / torch.clamp(integral_theta_den,
                                                     min=1e-30)

        mix = in_range & do_mix
        T = torch.where(mix, mean_theta * theta_coeff, T)
        q = torch.where(mix, mean_q[None, :], q)
    return T, q


class DryConvectiveAdjustment(Stepper):
    """Keep the temperature profile from being super-adiabatic, conserving
    enthalpy and moisture (:97), on ``device`` (the CUDA card unless the
    caller asks for another)."""

    input_properties = {
        'air_temperature': {'units': 'degK', 'dims': ['mid_levels', '*']},
        'air_pressure': {'units': 'Pa', 'dims': ['mid_levels', '*']},
        'air_pressure_on_interface_levels': {
            'units': 'Pa', 'dims': ['interface_levels', '*'],
            'alias': 'P_int'},
        'specific_humidity': {'units': 'kg/kg', 'dims': ['mid_levels', '*']},
    }

    output_properties = {
        'air_temperature': {'units': 'degK'},
        'specific_humidity': {'units': 'kg/kg'},
    }

    diagnostic_properties = {}

    def __init__(self, device='cuda', **kwargs):
        self.device = resolve_device(device)
        super().__init__(**kwargs)

    def array_call(self, state, timestep):
        T_out, q_out = dry_convective_adjustment(
            *(as_tensor(state[name], self.device) for name in (
                'air_temperature', 'specific_humidity', 'air_pressure',
                'P_int')),
            get_constant('heat_capacity_of_dry_air_at_constant_pressure',
                         'J/kg/degK'),
            get_constant('heat_capacity_of_vapor_phase', 'J/kg/K'),
            get_constant('gas_constant_of_dry_air', 'J/kg/degK'),
            get_constant('gas_constant_of_vapor_phase', 'J/kg/K'),
            get_constant('reference_air_pressure', 'Pa'))
        return {}, {'air_temperature': T_out, 'specific_humidity': q_out}
