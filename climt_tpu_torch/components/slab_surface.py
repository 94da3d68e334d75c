"""Slab surface energy balance (climt_tpu/components/slab_surface.py).

dT_s/dt = F_net / (rho c d), with per-area-type (land, sea, land_ice,
sea_ice) masks choosing density, heat capacity, slab depth and flux;
ice-covered points have zero tendency, open sea also takes the
``ocean_heat_transport_convergence`` q-flux, and with
``include_ekman=True`` the Ekman heat-transport convergence of the
wind-stress curl on the 2-D grid is added to it.  The string field
``area_type`` stays a numpy array; it becomes boolean masks on the host,
and everything after that is tensor arithmetic on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.base_components import TendencyComponent
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device
from ..ops.horizontal import curl_z, divergence


def slab_surface_tendency(
        lw_down_sfc, sw_down_sfc, lw_up_sfc, sw_up_sfc,
        latent_flux, sensible_flux, soil_heat_flux, ocean_ice_flux,
        q_flux_total,
        density, thermal_capacity, soil_capacity, sea_density,
        soil_thickness, ocean_thickness,
        land_mask, sea_mask, land_ice_mask, sea_ice_mask):
    """(tendency, slab depth) of the surface temperature (:31)."""
    net_flux = (sw_down_sfc + lw_down_sfc - sw_up_sfc - lw_up_sfc
                - sensible_flux - latent_flux)
    net_flux = torch.where(land_ice_mask, -soil_heat_flux, net_flux)
    net_flux = torch.where(sea_ice_mask, ocean_ice_flux, net_flux)
    net_flux = net_flux + torch.where(sea_mask & ~sea_ice_mask,
                                      q_flux_total, 0.0)
    density = torch.where(sea_mask, sea_density, density)
    capacity = torch.where(land_mask, soil_capacity, thermal_capacity)
    depth = torch.where(sea_mask, ocean_thickness,
                        torch.where(land_mask, soil_thickness, 0.0))
    heat_capacity_surface = density * depth * capacity
    tendency = torch.where(heat_capacity_surface != 0.0,
                           net_flux / heat_capacity_surface, 0.0)
    tendency = torch.where(land_ice_mask | sea_ice_mask, 0.0, tendency)
    return tendency, depth


def ekman_q_flux(tau_x, tau_y, lat2d, lon2d, theta2d, rho2d,
                 open_ocean, omega, c_sw, f_floor):
    """Ekman heat-transport convergence and pumping on the 2-D grid
    (:59): the stress is zeroed off the open sea before differentiating,
    the Coriolis parameter is floored at ``f_floor`` in magnitude."""
    tau_x = torch.where(open_ocean, tau_x, 0.0)
    tau_y = torch.where(open_ocean, tau_y, 0.0)
    f = 2.0 * omega * torch.sin(torch.deg2rad(lat2d))
    f_sign = torch.where(f >= 0.0, 1.0, -1.0).to(f.dtype)
    f_capped = f_sign * torch.clamp(torch.abs(f), min=f_floor)
    mx = tau_y / f_capped
    my = -tau_x / f_capped
    w_ek = curl_z(tau_x, tau_y, lat2d, lon2d) / (f_capped * rho2d)
    q_ekman = -c_sw * divergence(theta2d * mx, theta2d * my, lat2d, lon2d)
    return (torch.where(open_ocean, q_ekman, 0.0),
            torch.where(open_ocean, w_ek, 0.0))


class SlabSurface(TendencyComponent):
    """Surface temperature tendency of a slab land/ocean surface (:82),
    on ``device`` (the CUDA card unless the caller asks for another)."""

    input_properties = {
        'downwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'downwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'surface_upward_latent_heat_flux': {'dims': ['*'], 'units': 'W m^-2'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_thermal_capacity': {
            'dims': ['*'], 'units': 'J kg^-1 degK^-1'},
        'surface_material_density': {'dims': ['*'], 'units': 'kg m^-3'},
        'upward_heat_flux_at_ground_level_in_soil': {
            'dims': ['*'], 'units': 'W m^-2'},
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'soil_layer_thickness': {'dims': ['*'], 'units': 'm'},
        'ocean_mixed_layer_thickness': {'dims': ['*'], 'units': 'm'},
        'heat_capacity_of_soil': {'dims': ['*'], 'units': 'J kg^-1 degK^-1'},
        'sea_water_density': {'dims': ['*'], 'units': 'kg m^-3'},
        'ocean_heat_transport_convergence': {
            'dims': ['*'], 'units': 'W m^-2'},
    }

    tendency_properties = {
        'surface_temperature': {'dims': ['*'], 'units': 'degK s^-1'},
    }

    diagnostic_properties = {
        'depth_of_slab_surface': {'dims': ['*'], 'units': 'm'},
        'ocean_heat_transport_convergence': {
            'dims': ['*'], 'units': 'W m^-2'},
    }

    def __init__(self, include_ekman=False,
                 equatorial_ekman_cap_latitude=5.0, device='cuda',
                 **kwargs):
        """include_ekman adds the wind-stress-curl Ekman convergence to the
        applied q-flux (and the ekman_* diagnostics); the Coriolis
        parameter is capped below equatorial_ekman_cap_latitude
        degrees."""
        self.device = resolve_device(device)
        self._include_ekman = include_ekman
        self._eq_cap = equatorial_ekman_cap_latitude
        if include_ekman:
            self.input_properties = dict(self.input_properties)
            self.input_properties.update({
                'surface_downward_eastward_stress': {
                    'dims': ['lat', 'lon'], 'units': 'N m^-2'},
                'surface_downward_northward_stress': {
                    'dims': ['lat', 'lon'], 'units': 'N m^-2'},
                'latitude': {'dims': ['lat', 'lon'],
                             'units': 'degrees_north'},
                'longitude': {'dims': ['lat', 'lon'],
                              'units': 'degrees_east'},
            })
            self.diagnostic_properties = dict(self.diagnostic_properties)
            self.diagnostic_properties.update({
                'ekman_heat_transport_convergence': {
                    'dims': ['*'], 'units': 'W m^-2'},
                'ekman_pumping': {'dims': ['*'], 'units': 'm s^-1'},
            })
        super().__init__(**kwargs)

    def array_call(self, raw_state):
        def a(name):
            return as_tensor(raw_state[name], self.device)

        def mask(*kinds):
            return torch.as_tensor(np.isin(area_type, kinds),
                                   device=self.device)

        area_type = np.asarray(raw_state['area_type']).astype(str)
        q_flux = a('ocean_heat_transport_convergence')
        diagnostics = {}
        if self._include_ekman:
            lat2d = a('latitude')
            lon2d = a('longitude')
            if lat2d.dim() == 1:
                lat2d = lat2d.reshape(-1, 1)
                lon2d = lon2d.reshape(-1, 1)
            shape2d = lat2d.shape

            def grid2d(name):
                return a(name).reshape(shape2d)

            omega = get_constant('planetary_rotation_rate', 's^-1')
            q_ekman, w_ek = ekman_q_flux(
                grid2d('surface_downward_eastward_stress'),
                grid2d('surface_downward_northward_stress'), lat2d, lon2d,
                grid2d('surface_temperature'), grid2d('sea_water_density'),
                mask('sea').reshape(shape2d), omega,
                get_constant('heat_capacity_of_sea_water', 'J/kg/degK'),
                2.0 * omega * np.sin(np.deg2rad(self._eq_cap)))
            q_flux = q_flux + q_ekman.reshape(q_flux.shape)
            diagnostics['ekman_heat_transport_convergence'] = \
                q_ekman.reshape(q_flux.shape)
            diagnostics['ekman_pumping'] = w_ek.reshape(q_flux.shape)

        tendency, depth = slab_surface_tendency(
            *(a(name)[:, 0] for name in (
                'downwelling_longwave_flux_in_air',
                'downwelling_shortwave_flux_in_air',
                'upwelling_longwave_flux_in_air',
                'upwelling_shortwave_flux_in_air')),
            *(a(name) for name in (
                'surface_upward_latent_heat_flux',
                'surface_upward_sensible_heat_flux',
                'upward_heat_flux_at_ground_level_in_soil',
                'heat_flux_into_sea_water_due_to_sea_ice')),
            q_flux,
            *(a(name) for name in (
                'surface_material_density', 'surface_thermal_capacity',
                'heat_capacity_of_soil', 'sea_water_density',
                'soil_layer_thickness', 'ocean_mixed_layer_thickness')),
            mask('land', 'land_ice'), mask('sea', 'sea_ice'),
            mask('land_ice'), mask('sea_ice'))
        diagnostics['depth_of_slab_surface'] = depth
        diagnostics['ocean_heat_transport_convergence'] = q_flux
        return {'surface_temperature': tendency}, diagnostics
