"""Manabe bucket land hydrology (climt_tpu/components/bucket_hydrology.py).

Bulk-aerodynamic sensible and latent heat fluxes with the air-density
factors, beta-limited evaporation from a finite soil-moisture bucket, and
explicit surface-temperature and soil-moisture updates; ``num_layers=2``
adds a deep soil moisture/temperature store with saturation-gradient
exchange, optional drainage, overflow runoff and conductive coupling.
JAX's static arguments (:26) are Python branches here; the arithmetic
runs on ``device``.
"""

from __future__ import annotations

import torch

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device


def bucket_step(
        lw_down_sfc, sw_down_sfc, lw_up_sfc, sw_up_sfc,
        T_s, rho_surf, thickness, soil_capacity, soil_moisture,
        conv_precip, strat_precip, q_lowest, q_surface, T_lowest,
        p_lowest, v_lowest, u_lowest, w_deep, T_deep, dt,
        s_max, beta_param, latent_heat, bulk_coeff, rd, cp, rho_water,
        deep_smax, tau_m, deep_ratio, tau_drain,
        two_layer=None, have_tau_drain=None):
    """One bucket step over all columns (:27): (precipitation, latent,
    sensible, evaporation, new T_s, new soil moisture, new T_deep, new
    w_deep, runoff, deep moisture fraction), the last four zeros for one
    layer.  ``two_layer`` and ``have_tau_drain`` have JAX's meaning;
    omitted, w_deep None means one layer and tau_drain None no deep
    drainage."""
    if two_layer is None:
        two_layer = w_deep is not None
    if have_tau_drain is None:
        have_tau_drain = tau_drain is not None
    wind_speed = torch.sqrt(u_lowest ** 2 + v_lowest ** 2)
    # lowest-level air density from the ideal gas law: the bulk formulae
    # are mass fluxes
    air_density = p_lowest / (rd * T_lowest)
    potential_evap_mass = (air_density * bulk_coeff * wind_speed
                           * (q_surface - q_lowest))

    precipitation_rate = conv_precip + strat_precip

    beta_factor = torch.where(
        soil_moisture <= beta_param * s_max,
        soil_moisture / (beta_param * s_max), 1.0)
    evaporative_mass_flux = beta_factor * potential_evap_mass
    evaporation_rate = evaporative_mass_flux / rho_water

    latent_flux = latent_heat * evaporative_mass_flux
    sensible_flux = (air_density * cp * bulk_coeff * wind_speed
                     * (T_s - T_lowest))

    net_heat_flux = (sw_down_sfc + lw_down_sfc - sw_up_sfc - lw_up_sfc
                     - sensible_flux - latent_flux)
    fluxes = (precipitation_rate, latent_flux, sensible_flux,
              evaporation_rate)

    if not two_layer:
        soil_moisture_tendency = torch.where(
            (soil_moisture < s_max)
            | (precipitation_rate <= evaporation_rate),
            precipitation_rate - evaporation_rate, 0.0)
        heat_capacity_surface = rho_surf * thickness * soil_capacity
        new_T_s = T_s + net_heat_flux / heat_capacity_surface * dt
        new_soil = torch.clamp(
            soil_moisture + soil_moisture_tendency * dt, max=s_max)
        return fluxes + (new_T_s, new_soil) + (torch.zeros_like(T_s),) * 4

    # two layers: shallow<->deep exchange toward equal relative saturation,
    # optional deep drainage, overflow runoff, conductive thermal coupling
    f_sd = ((soil_moisture / s_max - w_deep / deep_smax)
            * (0.5 * (s_max + deep_smax)) / tau_m)
    drain = (w_deep / tau_drain if have_tau_drain
             else torch.zeros_like(w_deep))

    w_s_new = soil_moisture + (precipitation_rate - evaporation_rate
                               - f_sd) * dt
    w_d_new = w_deep + (f_sd - drain) * dt
    over_s = torch.clamp(w_s_new - s_max, min=0.0)
    over_d = torch.clamp(w_d_new - deep_smax, min=0.0)
    runoff = (over_s + over_d) / dt
    w_s_new = torch.clamp(w_s_new - over_s, 0.0, s_max)
    w_d_new = torch.clamp(w_d_new - over_d, 0.0, deep_smax)

    k_soil = 2.0                      # W/m/degK (reference constant)
    dz_s = thickness
    dz_d = deep_ratio * thickness
    c_s = rho_surf * dz_s * soil_capacity
    c_d = rho_surf * dz_d * soil_capacity
    g_sd = k_soil * (T_s - T_deep) / (0.5 * (dz_s + dz_d))
    new_T_s = T_s + (net_heat_flux - g_sd) / c_s * dt
    new_T_d = T_deep + g_sd / c_d * dt
    return fluxes + (new_T_s, w_s_new, new_T_d, w_d_new, runoff,
                     w_d_new / deep_smax)


class BucketHydrology(Stepper):
    """Slab surface with a Manabe moisture bucket, one or two layers
    (:101), on ``device`` (the CUDA card unless the caller asks for
    another)."""

    input_properties = {
        'downwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'downwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'surface_material_density': {'dims': ['*'], 'units': 'kg m^-3'},
        'soil_layer_thickness': {'dims': ['*'], 'units': 'm'},
        'heat_capacity_of_soil': {
            'dims': ['*'], 'units': 'J kg^-1 degK^-1'},
        'lwe_thickness_of_soil_moisture_content': {
            'dims': ['*'], 'units': 'm'},
        'convective_precipitation_rate': {
            'dims': ['*'], 'units': 'm s^-1'},
        'stratiform_precipitation_rate': {
            'dims': ['*'], 'units': 'm s^-1'},
        'specific_humidity': {'dims': ['mid_levels', '*'],
                              'units': 'kg/kg'},
        'surface_specific_humidity': {'dims': ['*'], 'units': 'kg/kg'},
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'northward_wind': {'dims': ['mid_levels', '*'],
                           'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
    }

    diagnostic_properties = {
        'precipitation_rate': {'dims': ['*'], 'units': 'm s^-1'},
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'evaporation_rate': {'dims': ['*'], 'units': 'm s^-1'},
    }

    output_properties = {
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'lwe_thickness_of_soil_moisture_content': {
            'dims': ['*'], 'units': 'm'},
    }

    def __init__(self, num_layers=1, soil_moisture_max=0.15,
                 beta_parameter=0.75,
                 specific_latent_heat_of_water=2260000,
                 bulk_coefficient=0.0011, deep_soil_moisture_max=0.50,
                 moisture_diffusion_timescale=None,
                 deep_layer_thickness_ratio=10.0,
                 deep_drainage_timescale=None, device='cuda', **kwargs):
        """num_layers=2 adds a deep moisture/temperature store (exchange
        toward equal relative saturation on moisture_diffusion_timescale,
        optional deep_drainage_timescale, overflow runoff_rate)."""
        if num_layers not in (1, 2):
            raise ValueError('num_layers must be 1 or 2')
        self.device = resolve_device(device)
        self._num_layers = num_layers
        self._smax = soil_moisture_max
        self._beta = beta_parameter
        self._latent = specific_latent_heat_of_water
        self._bulk = bulk_coefficient
        self._deep_smax = deep_soil_moisture_max
        self._tau_m = moisture_diffusion_timescale
        self._deep_ratio = deep_layer_thickness_ratio
        self._tau_drain = deep_drainage_timescale
        if num_layers == 2:
            deep = {
                'deep_soil_moisture_content': {'dims': ['*'], 'units': 'm'},
                'deep_soil_temperature': {'dims': ['*'], 'units': 'degK'},
            }
            self.input_properties = dict(self.input_properties, **deep)
            self.output_properties = dict(self.output_properties, **deep)
            self.diagnostic_properties = dict(self.diagnostic_properties, **{
                'runoff_rate': {'dims': ['*'], 'units': 'm s^-1'},
                'deep_soil_moisture_fraction': {
                    'dims': ['*'], 'units': 'dimensionless'},
            })
        super().__init__(**kwargs)

    def array_call(self, raw_state, timestep):
        def a(name):
            return as_tensor(raw_state[name], self.device)

        two_layer = self._num_layers == 2
        tau_m = self._tau_m if self._tau_m is not None else 5 * 86400.0
        out = bucket_step(
            *(a(name)[:, 0] for name in (
                'downwelling_longwave_flux_in_air',
                'downwelling_shortwave_flux_in_air',
                'upwelling_longwave_flux_in_air',
                'upwelling_shortwave_flux_in_air')),
            *(a(name) for name in (
                'surface_temperature', 'surface_material_density',
                'soil_layer_thickness', 'heat_capacity_of_soil',
                'lwe_thickness_of_soil_moisture_content',
                'convective_precipitation_rate',
                'stratiform_precipitation_rate')),
            a('specific_humidity')[0], a('surface_specific_humidity'),
            *(a(name)[0] for name in (
                'air_temperature', 'air_pressure', 'northward_wind',
                'eastward_wind')),
            a('deep_soil_moisture_content') if two_layer else None,
            a('deep_soil_temperature') if two_layer else None,
            timestep_seconds(timestep),
            self._smax, self._beta, self._latent, self._bulk,
            get_constant('gas_constant_of_dry_air', 'J kg^-1 K^-1'),
            get_constant('heat_capacity_of_dry_air_at_constant_pressure',
                         'J kg^-1 K^-1'),
            get_constant('density_of_liquid_water', 'kg m^-3'),
            self._deep_smax, tau_m, self._deep_ratio, self._tau_drain,
            two_layer, self._tau_drain is not None)

        diagnostics = dict(zip(
            ('precipitation_rate', 'surface_upward_latent_heat_flux',
             'surface_upward_sensible_heat_flux', 'evaporation_rate'),
            out[:4]))
        new_state = {
            'surface_temperature': out[4],
            'lwe_thickness_of_soil_moisture_content': out[5],
        }
        if two_layer:
            new_state['deep_soil_temperature'] = out[6]
            new_state['deep_soil_moisture_content'] = out[7]
            diagnostics['runoff_rate'] = out[8]
            diagnostics['deep_soil_moisture_fraction'] = out[9]
        return diagnostics, new_state
