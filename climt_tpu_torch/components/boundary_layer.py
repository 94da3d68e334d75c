"""Simple boundary-layer scheme, Frierson, Held & Zurita-Gotor 2006
(climt_tpu/components/boundary_layer.py).

Simplified Monin-Obukhov diffusivities with a K-profile capped by a
critical Richardson number, an implicit vertical diffusion of T, q, u and
v, and three surface-exchange modes ('bulk' internal fluxes, 'external'
prescribed fluxes, None no flux).  Whole-grid tensor arithmetic on
``device``: the boundary-layer top is the first interface whose
Richardson number exceeds the critical one (an argmax over an integer
mask; torch, like JAX, returns the first maximum), and the four implicit
solves are batched tridiagonal solves over every column
(ops/tridiagonal.py).
"""

from __future__ import annotations

import torch

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device
from ..ops.tridiagonal import tridiagonal_solve

_FLUX_MODES = {None: 0, 'bulk': 1, 'external': 2}


def _richardson_diffusivity(ri_a, u_fric, c_drag, z, k, z0, ric):
    """Surface-layer diffusion coefficient K_b (thesis Eqn 2.8) (:34)."""
    base = k * u_fric * torch.sqrt(c_drag) * z
    stable = base / (1.0 + ri_a / ric * torch.log(z / z0)
                     / (1.0 - ri_a / ric))
    return torch.where(ri_a <= 0.0, base, stable)


def _diffuse_profile(profile, p, p_int, rho, diff, dt, g,
                     surface_exchange, surface_source):
    """Implicit vertical diffusion with a surface boundary term (:42);
    arrays are (levels, ncol), rho and diff on the nz-1 interior
    interfaces."""
    zeros_row = torch.zeros_like(profile[:1])
    diag_m = torch.cat([
        zeros_row,
        g * g * rho * rho * diff * dt
        / (p[:-1] - p[1:]) / (p_int[1:-1] - p_int[2:]),
    ], dim=0)
    diag_p = torch.cat([
        g * g * rho * rho * diff * dt
        / (p[:-1] - p[1:]) / (p_int[:-2] - p_int[1:-1]),
        zeros_row,
    ], dim=0)
    diag = 1.0 + diag_m + diag_p
    diag[0] += surface_exchange
    rhs = profile.clone()
    rhs[0] += surface_source
    return tridiagonal_solve(-diag_m, diag, -diag_p, rhs)


def boundary_layer_step(T, Ts, p, p_int, ps, q, qs, v, u,
                        sensible_in, latent_in, dt, flux_mode,
                        Rd, Cp, g, k, z0, fb, P0, Ric, Lv):
    """One SimpleBoundaryLayer step over all columns (:66).

    Shapes: profiles (nz, ncol), p_int (nz+1, ncol), surface fields
    (ncol,).  Returns (new_T, new_q, new_v, new_u, stress_n, stress_e,
    bl_height, applied_sensible, applied_latent).
    """
    v_int = 0.5 * (v[1:] + v[:-1])
    u_int = 0.5 * (u[1:] + u[:-1])
    T_int = 0.5 * (T[1:] + T[:-1])
    q_int = 0.5 * (q[1:] + q[:-1])
    p_mid_int = p_int[1:-1]
    rho = p_mid_int / (Rd * (1.0 + 0.608 * q_int) * T_int)

    pot_virt = (T_int * (P0 / p_mid_int) ** (Rd / Cp)
                * (1.0 + 0.608 * q_int))
    pot_virt_surf = Ts * (P0 / ps) ** (Rd / Cp) * (1.0 + 0.608 * qs)

    # interior-interface heights by hydrostatic integration
    dz0 = (Rd * (1.0 + 0.608 * q[0]) * T[0] / g) * torch.log(
        ps / p_mid_int[0])
    dzs = (Rd * (1.0 + 0.608 * q[1:-1]) * T[1:-1] / g
           * torch.log(p_mid_int[:-1] / p_mid_int[1:]))
    z = torch.cat([dz0[None], dzs], dim=0).cumsum(dim=0)

    wind_int = torch.clamp(torch.sqrt(v_int ** 2 + u_int ** 2), min=1.0)

    ri_a = (g * z[0] * (pot_virt[0] - pot_virt_surf)
            / (pot_virt_surf * wind_int[0] ** 2))
    log_term = torch.log(z[0] / z0) ** -2
    c_drag = torch.where(
        ri_a < 0.0, k * k * log_term,
        torch.where(ri_a < Ric,
                    k * k * log_term * (1.0 - ri_a / Ric) ** 2, 0.0))

    # boundary-layer top: the first interface whose local Ri exceeds Ric;
    # count 0 when none does, and then h = z[-1]
    rich = (g * z * (pot_virt - pot_virt[0])
            / (pot_virt[0] * wind_int ** 2))
    exceed = rich > Ric
    found = exceed.any(dim=0)
    first = torch.argmax(exceed.to(torch.uint8), dim=0)
    count = torch.where(found, first + 1, 0)
    n = z.shape[0]
    h = torch.gather(z, 0, torch.where(found, first, n - 1)[None])[0]

    u_fric = wind_int[0]
    dp0 = p_int[0] - p_int[1]
    bulk_conductance = rho[0] * c_drag * wind_int[0]
    beta = g * bulk_conductance * dt / dp0

    zero = torch.zeros_like(beta)
    if flux_mode == 1:
        scalar_exchange = beta
        source_T = beta * Ts
        source_q = beta * qs
    elif flux_mode == 2:
        scalar_exchange = zero
        source_T = g * dt * sensible_in / (Cp * dp0)
        source_q = g * dt * latent_in / (Lv * dp0)
    else:
        scalar_exchange = source_T = source_q = zero
    wind_exchange = zero if flux_mode == 0 else beta

    # K-profile: surface-layer form below fb*h, decaying profile above;
    # zero at and above the boundary-layer top (i >= count)
    level = torch.arange(n, device=z.device)[:, None]
    in_bl = level < count[None, :]
    k_surf = _richardson_diffusivity(ri_a, u_fric, c_drag, z, k, z0, Ric)
    k_top = _richardson_diffusivity(ri_a, u_fric, c_drag, fb * h,
                                    k, z0, Ric)
    k_prof = (k_top * z / (h * fb)
              * (1.0 - (z - fb * h) / ((1.0 - fb) * h)) ** 2)
    diff = torch.where(z < fb * h, k_surf, k_prof)
    diff = torch.where(in_bl, diff, 0.0)

    new_T = _diffuse_profile(T, p, p_int, rho, diff, dt, g,
                             scalar_exchange, source_T)
    new_q = _diffuse_profile(q, p, p_int, rho, diff, dt, g,
                             scalar_exchange, source_q)
    new_v = _diffuse_profile(v, p, p_int, rho, diff, dt, g,
                             wind_exchange, zero)
    new_u = _diffuse_profile(u, p, p_int, rho, diff, dt, g,
                             wind_exchange, zero)

    applied_sensible = Cp * bulk_conductance * (Ts - new_T[0])
    applied_latent = Lv * bulk_conductance * (qs - new_q[0])
    stress_n = bulk_conductance * new_v[0]
    stress_e = bulk_conductance * new_u[0]
    return (new_T, new_q, new_v, new_u, stress_n, stress_e, h,
            applied_sensible, applied_latent)


class SimpleBoundaryLayer(Stepper):
    """Boundary-layer diffusion of heat, moisture and momentum with
    Frierson (2006) surface exchange (:163), on ``device`` (the CUDA card
    unless the caller asks for another)."""

    input_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {
            'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'Pa'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'surface_specific_humidity': {'dims': ['*'], 'units': 'kg/kg'},
    }

    output_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {
            'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
    }

    diagnostic_properties = {
        'northward_wind_stress': {'dims': ['*'], 'units': 'Pa'},
        'eastward_wind_stress': {'dims': ['*'], 'units': 'Pa'},
        'boundary_layer_height': {'dims': ['*'], 'units': 'm'},
    }

    def __init__(self, surface_fluxes='bulk', von_karman_constant=0.4,
                 roughness_length=0.0000321, specific_fraction=0.1,
                 reference_pressure=100000, critical_richardson_number=1,
                 device='cuda', **kwargs):
        """surface_fluxes: 'bulk' (internal implicit bulk fluxes,
        reported as diagnostics), 'external' (prescribed flux inputs), or
        None (no surface exchange)."""
        if surface_fluxes not in _FLUX_MODES:
            raise ValueError(
                "surface_fluxes must be 'bulk', 'external' or None, "
                'got {!r}'.format(surface_fluxes))
        self.device = resolve_device(device)
        self._flux_mode = _FLUX_MODES[surface_fluxes]
        self._k = von_karman_constant
        self._z0 = roughness_length
        self._fb = specific_fraction
        self._P0 = reference_pressure
        self._Ric = critical_richardson_number
        flux_props = {
            'surface_upward_sensible_heat_flux': {
                'dims': ['*'], 'units': 'W m^-2'},
            'surface_upward_latent_heat_flux': {
                'dims': ['*'], 'units': 'W m^-2'},
        }
        if surface_fluxes == 'bulk':
            self.diagnostic_properties = dict(self.diagnostic_properties,
                                              **flux_props)
        elif surface_fluxes == 'external':
            self.input_properties = dict(self.input_properties, **flux_props)
        super().__init__(**kwargs)

    def array_call(self, state, timestep):
        def a(name):
            return as_tensor(state[name], self.device)

        T = a('air_temperature')
        if self._flux_mode == 2:
            sensible = a('surface_upward_sensible_heat_flux')
            latent = a('surface_upward_latent_heat_flux')
        else:
            sensible = latent = torch.zeros_like(T[0])

        (new_T, new_q, new_v, new_u, stress_n, stress_e, h,
         applied_sensible, applied_latent) = boundary_layer_step(
            T, a('surface_temperature'), a('air_pressure'),
            a('air_pressure_on_interface_levels'),
            a('surface_air_pressure'), a('specific_humidity'),
            a('surface_specific_humidity'), a('northward_wind'),
            a('eastward_wind'), sensible, latent,
            timestep_seconds(timestep), self._flux_mode,
            get_constant('gas_constant_of_dry_air', 'J kg^-1 K^-1'),
            get_constant('heat_capacity_of_dry_air_at_constant_pressure',
                         'J kg^-1 K^-1'),
            get_constant('gravitational_acceleration', 'm s^-2'),
            self._k, self._z0, self._fb, self._P0, self._Ric,
            get_constant('latent_heat_of_condensation', 'J kg^-1'))

        new_state = {
            'air_temperature': new_T,
            'specific_humidity': new_q,
            'northward_wind': new_v,
            'eastward_wind': new_u,
        }
        diagnostics = {
            'northward_wind_stress': stress_n,
            'eastward_wind_stress': stress_e,
            'boundary_layer_height': h,
        }
        if self._flux_mode == 1:
            diagnostics['surface_upward_sensible_heat_flux'] = \
                applied_sensible
            diagnostics['surface_upward_latent_heat_flux'] = applied_latent
        return diagnostics, new_state
