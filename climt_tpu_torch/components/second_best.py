"""SecondBEST: the modular intermediate-complexity BEST land-surface
model (climt_tpu/components/second_best.py).

A Stepper over five swappable process objects (SoilProperties,
SurfaceAlbedo, SurfaceLayer, SurfaceFluxes, SubsurfaceTransport), each
with a ``Best*`` default, plus stability-consistent screen-level
diagnostics (T and q at 2 m, wind at 10 m).  The JAX code mixes jnp and
numpy on state fields (:193-222, :315-375); here every step is tensor
arithmetic on ``device`` over all columns, and the subsurface implicit
diffusion is one batched tridiagonal solve (ops/tridiagonal.py).  The
process objects keep JAX's names and call contracts, on tensors;
``SoilProperties`` also takes the dtype of its per-column parameters.
"""

from __future__ import annotations

import math

import torch

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import area_mask, resolve_device
from ..ops.tridiagonal import tridiagonal_solve


def _where(cond, a, b, dtype):
    """torch.where of two Python floats at ``dtype``."""
    return torch.where(cond, torch.tensor(a, dtype=dtype,
                                          device=cond.device), b)


class SoilProperties:
    """__call__(soil_type, land_ice_mask, dtype) -> dict of per-column
    params."""

    def __call__(self, soil_type, land_ice_mask, dtype):
        raise NotImplementedError


class BestSoilProperties(SoilProperties):
    """BEST Eqs 4.10-4.12 soil parameters by type and area (:35)."""

    _COLOUR = {'clay': 0.2, 'sand': 1.0}
    _TEXTURE = {'clay': 0.0, 'sand': 9.0}
    _B = {'clay': 10.0, 'sand': 4.0}
    _K_H0 = {'clay': 0.001, 'sand': 0.1}

    def __call__(self, soil_type, land_ice_mask, dtype):
        colour = self._COLOUR[soil_type]
        texture = _where(land_ice_mask, 0.07, self._TEXTURE[soil_type],
                         dtype)
        porosity = 0.6 - 0.03 * texture
        field_capacity = (0.95 - 0.086 * texture) * porosity
        wilting_point = _where(land_ice_mask, 0.01, porosity - 0.03, dtype)
        return {
            'colour': colour, 'texture': texture, 'porosity': porosity,
            'field_capacity': field_capacity,
            'wilting_point': wilting_point,
            'B': self._B[soil_type], 'K_H0': self._K_H0[soil_type],
            'psi_0': -0.2,
        }


class SurfaceAlbedo:
    def __call__(self, soil_props, wetness, land_ice_mask):
        raise NotImplementedError


class BestSurfaceAlbedo(SurfaceAlbedo):
    """BEST Eqs 5.5-5.8 (:63)."""

    def __call__(self, soil_props, wetness, land_ice_mask):
        ice_sw = 0.60 + 0.06 * (1.0 - wetness)
        soil_sw = (0.10 + 0.1 * soil_props['colour']
                   + 0.06 * (1.0 - wetness))
        alpha_sw = torch.where(land_ice_mask, ice_sw, soil_sw)
        alpha_lw = torch.where(land_ice_mask, alpha_sw / 3.0,
                               2.0 * alpha_sw)
        return {'alpha_sw': alpha_sw, 'alpha_lw': alpha_lw}


class SurfaceLayer:
    def __call__(self, z_mid, z0, wind_speed, T_surf, T_air):
        raise NotImplementedError

    def interpolate_to_height(self, drag, z0, z_mid, z_target,
                              surface_value, level_value, kind):
        """Screen-level diagnosis between the surface and the lowest level
        with the stability profile recovered from the bulk coefficients
        (the neutral log law when C_Dm == C_Dh == C_DN) (:79)."""
        kappa = get_constant('von_karman_constant', 'dimensionless')
        ln_mid = torch.log(z_mid / z0)
        ln_tgt = torch.log(z_target / z0)
        frac = z_target / z_mid
        c_dm, c_dh = drag['C_Dm'], drag['C_Dh']
        if kind == 'wind':
            psi_m = ln_mid - kappa / torch.sqrt(c_dm)
            weight = torch.clamp((ln_tgt - psi_m * frac) / (ln_mid - psi_m),
                                 0.0, 1.0)
            return level_value * weight
        psi_h = ln_mid - kappa * torch.sqrt(c_dm) / c_dh
        weight = torch.clamp((ln_tgt - psi_h * frac) / (ln_mid - psi_h),
                             0.0, 1.0)
        return surface_value + (level_value - surface_value) * weight


class BestSurfaceLayer(SurfaceLayer):
    """BEST Section 6 stability-dependent bulk drag, land eps=0.01
    (:100)."""

    def __call__(self, z_mid, z0, wind_speed, T_surf, T_air):
        kappa = get_constant('von_karman_constant', 'dimensionless')
        g = get_constant('gravitational_acceleration', 'm/s^2')
        U = torch.clamp(wind_speed, min=1e-3)
        c_dn = (kappa / (torch.log(z_mid) - torch.log(z0))) ** 2
        zeta = torch.exp(-kappa / torch.sqrt(c_dn))
        ri = -(g * z_mid / (T_surf * U * U)) * (T_surf - T_air)
        eps = 0.01
        unstable = ri < 0.0
        c_dm = torch.where(
            unstable,
            c_dn * (1 - 8 * ri
                    / (1 + 56.768 * c_dn * torch.sqrt(torch.abs(ri) / zeta))),
            c_dn * ((1 - 4 * eps * ri) ** 2) / (1 + 8 * (1 - eps) * ri))
        c_dh = torch.where(
            unstable,
            c_dn * (1 - 12 * ri
                    / (1 + 41.801 * c_dn * torch.sqrt(torch.abs(ri) / zeta))),
            c_dn * ((1 - 4 * eps * ri) / (1 + (6 - 4 * eps) * ri)) ** 2)
        return {'C_Dm': c_dm, 'C_Dh': c_dh, 'C_DN': c_dn, 'Ri': ri}


class SurfaceFluxes:
    def __call__(self, drag, atmos, soil, soil_props, timestep):
        raise NotImplementedError


class BestSurfaceFluxes(SurfaceFluxes):
    """BEST Section 8 bulk fluxes with the beta wetness limiter (:130)."""

    def __call__(self, drag, atmos, soil, soil_props, timestep):
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/degK')
        lv = get_constant('latent_heat_of_vaporization', 'J/kg')
        lf = get_constant('latent_heat_of_fusion', 'J/kg')
        li = lv + lf
        rho = atmos['air_density']
        U = atmos['wind_speed']
        shf = (rho * cpd * U * drag['C_Dh']
               * (soil['surface_temperature'] - atmos['air_temperature']))

        w_lu, w_fu = soil['W_Lu'], soil['W_Fu']
        c_u = drag['C_Dh'] * U
        dq = (soil['saturation_specific_humidity']
              - atmos['air_specific_humidity'])
        e_pot = rho * c_u * dq
        b = soil_props['B']
        k_h0 = soil_props['K_H0']
        theta = torch.clamp((w_lu - 0.01) / torch.clamp(1.0 - w_fu, min=1e-6),
                            1e-3, 1.0)
        rho_w = get_constant('density_of_liquid_water', 'kg/m^3')
        xv = soil_props['porosity']
        psi0 = soil_props['psi_0']
        k_hd = (-4 * k_h0 * b * psi0 * rho_w * xv * (1 - w_fu)) \
            / (math.pi * timestep)
        e_max = k_hd * theta ** (0.5 * b + 2) - k_h0 * theta ** (2 * b + 3)
        frozen_term = (w_fu * lv / li) if li > 0 else 0.0
        significant = torch.abs(e_pot) > 1e-12
        ratio = torch.where(
            significant,
            torch.clamp(e_max / torch.where(significant, e_pot, 1.0),
                        0.0, 1.0),
            0.0)
        beta_u = torch.clamp(frozen_term + ratio, 0.0, 1.0)

        evaporation = beta_u * e_pot / rho
        lhf = lv * rho * evaporation
        momentum = -rho * drag['C_Dm'] * U
        return {'sensible_heat_flux': shf, 'latent_heat_flux': lhf,
                'momentum_flux': momentum, 'evaporation': evaporation,
                'beta': torch.clamp(beta_u, 0.0, 1.0)}


class SubsurfaceTransport:
    def __call__(self, profiles, surface_flux_bc, timestep, dz):
        raise NotImplementedError


class BestSubsurfaceTransport(SubsurfaceTransport):
    """Implicit heat diffusion + explicit freeze/melt (BEST conduction)
    (:179).

    Batched over columns: profiles are (n_levels, ncol), dz (ncol,).
    Node 0 = bottom, node n-1 = surface; Neumann at both ends with the
    surface flux entering the top row's right-hand side.
    """

    def __init__(self, thermal_conductivity=2.0,
                 volumetric_heat_capacity=2.0e6):
        self._kappa = thermal_conductivity
        self._cv = volumetric_heat_capacity

    def __call__(self, profiles, surface_flux_bc, timestep, dz):
        T, x_w, x_i = profiles['T'], profiles['X_w'], profiles['X_i']
        tf = get_constant('freezing_temperature_of_liquid_phase', 'degK')
        lf = get_constant('latent_heat_of_fusion', 'J/kg')
        rho_w = get_constant('density_of_liquid_water', 'kg/m^3')
        kappa, cv = self._kappa, self._cv
        dt = float(timestep)

        rr = kappa * dt / (cv * dz * dz)            # (ncol,)
        rr_full = torch.broadcast_to(rr, T.shape)
        lower = -rr_full
        lower[0] = 0.0
        upper = -rr_full
        upper[-1] = 0.0
        main = 1.0 + 2.0 * rr_full
        main[0] += -rr                              # Neumann rows
        main[-1] += -rr
        rhs = T.clone()
        rhs[-1] += surface_flux_bc * dt / (cv * dz)
        T_diff = tridiagonal_solve(lower, main, upper, rhs)

        gamma = (cv / lf) * (tf - T_diff) / dt
        gamma = torch.minimum(torch.maximum(gamma, -rho_w * x_i / dt),
                              rho_w * x_w / dt)
        x_i_new = x_i + gamma * dt / rho_w
        x_w_new = x_w - gamma * dt / rho_w
        T_new = T_diff + lf * gamma * dt / cv
        T_new = torch.where(surface_flux_bc[None, :] <= 0,
                            torch.clamp(T_new, max=tf), T_new)
        return {'T': T_new, 'X_w': torch.clamp(x_w_new, min=0.0),
                'X_i': torch.clamp(x_i_new, min=0.0)}


def _saturation_specific_humidity(T, p):
    es = 611.2 * torch.exp(17.67 * (T - 273.15) / (T - 29.65))
    return 0.622 * es / (p - 0.378 * es)


class SecondBEST(Stepper):
    """Modular BEST land surface model (:230), on ``device`` (the CUDA card
    unless the caller asks for another)."""

    input_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {
            'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'downwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'downwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'soil_temperature': {
            'dims': ['soil_interface_levels', '*'], 'units': 'degK'},
        'soil_liquid_water_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'soil_ice_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'height_on_soil_interface_levels': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm'},
    }

    output_properties = {
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'soil_temperature': {
            'dims': ['soil_interface_levels', '*'], 'units': 'degK'},
        'soil_liquid_water_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'soil_ice_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'evaporation_rate': {'dims': ['*'], 'units': 'm s^-1'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_drag_coefficient_for_heat': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_drag_coefficient_for_momentum': {
            'dims': ['*'], 'units': 'dimensionless'},
        'air_temperature_at_2m': {'dims': ['*'], 'units': 'degK'},
        'specific_humidity_at_2m': {'dims': ['*'], 'units': 'kg/kg'},
        'eastward_wind_at_10m': {'dims': ['*'], 'units': 'm s^-1'},
        'northward_wind_at_10m': {'dims': ['*'], 'units': 'm s^-1'},
    }

    def __init__(self, soil_type='clay', num_soil_layers=3,
                 minimum_wind_speed=1.0, soil_properties=None, albedo=None,
                 surface_layer=None, fluxes=None, subsurface=None,
                 device='cuda', **kwargs):
        """Pass process instances to override any of the five BEST
        defaults (soil_properties, albedo, surface_layer, fluxes,
        subsurface)."""
        self.device = resolve_device(device)
        self._soil_type = soil_type
        self._num_soil_layers = num_soil_layers
        self._min_wind = minimum_wind_speed
        self._soil_props = soil_properties or BestSoilProperties()
        self._albedo = albedo or BestSurfaceAlbedo()
        self._surface_layer = surface_layer or BestSurfaceLayer()
        self._fluxes = fluxes or BestSurfaceFluxes()
        self._subsurface = subsurface or BestSubsurfaceTransport()
        super().__init__(**kwargs)

    def array_call(self, state, timestep):
        def a(name):
            return as_tensor(state[name], self.device)

        rd = get_constant('gas_constant_of_dry_air', 'J/kg/degK')
        g = get_constant('gravitational_acceleration', 'm/s^2')
        dt = timestep_seconds(timestep)

        land = area_mask(state['area_type'], ['land', 'land_ice'],
                         self.device)
        land_ice = area_mask(state['area_type'], ['land_ice'], self.device)

        T_air = a('air_temperature')[0]
        dtype = T_air.dtype
        props = self._soil_props(self._soil_type, land_ice, dtype)

        u = a('eastward_wind')[0]
        v = a('northward_wind')[0]
        wind = torch.clamp(torch.sqrt(u * u + v * v), min=self._min_wind)
        p = a('air_pressure')[0]
        rho = p / (rd * T_air)
        p_surf = a('surface_air_pressure')
        z_mid = torch.clamp((rd * T_air / g) * torch.log(p_surf / p),
                            min=2.0)
        z0 = _where(land_ice, 0.001, 0.01, dtype)

        T_surf = a('surface_temperature')
        drag = self._surface_layer(z_mid, z0, wind, T_surf, T_air)

        x_w = a('soil_liquid_water_content')
        x_i = a('soil_ice_content')
        w_lu = x_w[-1] / props['porosity']
        albedo = self._albedo(props, w_lu, land_ice)

        q_air = a('specific_humidity')[0]
        q_sat = _saturation_specific_humidity(T_surf, p)
        atmos = {'air_density': rho, 'wind_speed': wind,
                 'air_temperature': T_air,
                 'air_specific_humidity': q_air, 'u': u, 'v': v}
        soil = {'surface_temperature': T_surf,
                'saturation_specific_humidity': q_sat,
                'W_Lu': w_lu, 'W_Fu': x_i[-1] / props['porosity']}
        flux = self._fluxes(drag, atmos, soil, props, dt)

        net = (a('downwelling_shortwave_flux_in_air')[:, 0]
               + a('downwelling_longwave_flux_in_air')[:, 0]
               - a('upwelling_shortwave_flux_in_air')[:, 0]
               - a('upwelling_longwave_flux_in_air')[:, 0]
               - flux['sensible_heat_flux'] - flux['latent_heat_flux'])

        z = a('height_on_soil_interface_levels')
        dz = (torch.abs(z[1] - z[0]) if z.shape[0] > 1
              else torch.full_like(T_surf, 0.5))
        soil_T = a('soil_temperature')
        new_prof = self._subsurface(
            {'T': soil_T, 'X_w': x_w, 'X_i': x_i},
            surface_flux_bc=net, timestep=dt, dz=dz)

        landl = land[None, :]
        outputs = {
            'soil_temperature': torch.where(landl, new_prof['T'], soil_T),
            'soil_liquid_water_content': torch.where(landl, new_prof['X_w'],
                                                     x_w),
            'soil_ice_content': torch.where(landl, new_prof['X_i'], x_i),
            'surface_temperature': torch.where(land, new_prof['T'][-1],
                                               T_surf),
            'surface_snow_thickness': a('surface_snow_thickness'),
        }

        q_surf_eff = (flux['beta'] * q_sat
                      + (1.0 - flux['beta']) * q_air)
        t2m = self._surface_layer.interpolate_to_height(
            drag, z0, z_mid, 2.0, T_surf, T_air, 'scalar')
        q2m = self._surface_layer.interpolate_to_height(
            drag, z0, z_mid, 2.0, q_surf_eff, q_air, 'scalar')
        spd10 = self._surface_layer.interpolate_to_height(
            drag, z0, z_mid, 10.0, 0.0, wind, 'wind')
        spd = torch.sqrt(u * u + v * v)
        moving = spd > 0.0
        safe_spd = torch.where(moving, spd, 1.0)
        u10 = torch.where(moving, spd10 * u / safe_spd, 0.0)
        v10 = torch.where(moving, spd10 * v / safe_spd, 0.0)

        def on_land(x):
            return torch.where(land, x, 0.0)

        diagnostics = {
            'surface_upward_sensible_heat_flux': on_land(
                flux['sensible_heat_flux']),
            'surface_upward_latent_heat_flux': on_land(
                flux['latent_heat_flux']),
            'evaporation_rate': on_land(flux['evaporation']),
            'surface_albedo_for_direct_shortwave': on_land(
                albedo['alpha_sw']),
            'surface_albedo_for_diffuse_shortwave': on_land(
                albedo['alpha_sw']),
            'surface_drag_coefficient_for_heat': on_land(drag['C_Dh']),
            'surface_drag_coefficient_for_momentum': on_land(
                drag['C_Dm']),
            'air_temperature_at_2m': on_land(t2m),
            'specific_humidity_at_2m': on_land(q2m),
            'eastward_wind_at_10m': on_land(u10),
            'northward_wind_at_10m': on_land(v10),
        }
        return diagnostics, outputs
