"""RRTMGShortwave: 14-band, 112-g-point correlated-k shortwave radiation
(climt_tpu/components/rrtmg/shortwave.py).

The component computes on its ``device`` (the CUDA card unless the caller
asks for another) at the state's float type: taumol through kernel-B
groups, the cloud optics of ``cldprop_sw``, ECMWF or direct aerosol
optics, and the two-stream solver with the Pade-table exponential, with
the solar-variability options and the earth-sun distance of
``state['time']``.  McICA subcolumns are drawn as in ``longwave.py``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...core.base_components import TendencyComponent
from ...core.constants import get_constant
from ...core.dataarray import as_tensor
from ...core.util import mass_to_volume_mixing_ratio, resolve_device
from . import sw_spectral as S
from .common import (
    rrtmg_aerosol_input_dict, rrtmg_cloud_ice_props_dict,
    rrtmg_cloud_liquid_props_dict, rrtmg_cloud_overlap_method_dict,
    rrtmg_cloud_props_dict, rrtmg_random_number_dict,
    validate_mcica_options)
from .longwave import per_call_generator
from .mcica import mcica_subcolumns


def _sw_driver(play, plev, tlay, h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr,
               o2vmr, asdir, asdif, aldir, aldif, coszen, cldfrac,
               tauc_in, ssac_in, asmc_in, fsfc_in, ciwp, clwp, rei, rel,
               taua_in, ssaa_in, asma_in, ecaer, adjes,
               grav, avogadro, cpdair,
               isolvar, icld, inflag, iceflag, liqflag, iaer,
               day_of_year, solar_config, generator=None):
    """Cloud and aerosol optics, then rrtmg_sw_fluxes (:44); McICA
    subcolumns when a generator is given and icld is not 0."""
    nz, ncol = play.shape
    zero_b = torch.zeros((nz, ncol, S.NBANDS), dtype=play.dtype,
                         device=play.device)
    if icld == 0:
        cloud = (zero_b, torch.ones_like(zero_b), zero_b, zero_b)
    else:
        cloud = S.cldprop_sw(inflag, iceflag, liqflag, cldfrac, tauc_in,
                             ssac_in, asmc_in, fsfc_in, ciwp, clwp, rei,
                             rel)
    if iaer == 0:
        aerosol = (zero_b, torch.ones_like(zero_b), zero_b)
    elif iaer == 6:
        aerosol = S.ecmwf_aerosol_optics(ecaer)
    else:                                           # 10: direct band input
        aerosol = (taua_in, ssaa_in, asma_in)

    common = dict(adjes=adjes, day_of_year=day_of_year, scon=0.0,
                  isolvar=isolvar, solar_config=solar_config, grav=grav,
                  avogadro=avogadro, cpdair=cpdair, icld=icld)
    args = (play, plev, tlay, h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr,
            asdir, asdif, aldir, aldif, coszen, cldfrac)
    if generator is not None and icld != 0:
        # per-g cloud optics are the delta-scaled band values of the
        # cloudy subcolumns (rrtmg_sw_cldprmc.f90)
        tauc_b, ssac_b, asmc_b, _ = cloud
        cldfmc, _, _, taucmc = mcica_subcolumns(
            generator, icld, cldfrac, ciwp, clwp, tauc_b, S.NGB)
        ngb = torch.as_tensor(S.NGB, dtype=torch.int64, device=play.device)
        iscld = cldfmc > 0
        cloud_g = (cldfmc, taucmc, torch.where(iscld, ssac_b[..., ngb], 1.0),
                   torch.where(iscld, asmc_b[..., ngb], 0.0))
        return S.rrtmg_sw_fluxes(*args, cloud_optics=cloud,
                                 aerosol_optics=aerosol, per_g_cloud=True,
                                 cloud_g=cloud_g, **common)
    return S.rrtmg_sw_fluxes(*args, cloud_optics=cloud,
                             aerosol_optics=aerosol, **common)


class RRTMGShortwave(TendencyComponent):
    """Shortwave radiative transfer with the RRTMG interface."""

    num_shortwave_bands = 14
    num_ecmwf_aerosols = 6
    num_reduced_g_intervals = 112

    input_properties = {
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'mbar'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'mbar'},
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {'dims': ['mid_levels', '*'],
                              'units': 'g/g'},
        'mole_fraction_of_ozone_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mole_fraction_of_carbon_dioxide_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mole_fraction_of_methane_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mole_fraction_of_nitrous_oxide_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mole_fraction_of_oxygen_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mass_content_of_cloud_ice_in_atmosphere_layer': {
            'dims': ['mid_levels', '*'], 'units': 'g m^-2'},
        'mass_content_of_cloud_liquid_water_in_atmosphere_layer': {
            'dims': ['mid_levels', '*'], 'units': 'g m^-2'},
        'cloud_ice_particle_size': {
            'dims': ['mid_levels', '*'], 'units': 'micrometer'},
        'cloud_water_droplet_radius': {
            'dims': ['mid_levels', '*'], 'units': 'micrometer'},
        'cloud_area_fraction_in_atmosphere_layer': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'zenith_angle': {'dims': ['*'], 'units': 'radians'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_direct_near_infrared': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_near_infrared': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'shortwave_optical_thickness_due_to_cloud': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless'},
        'shortwave_optical_thickness_due_to_aerosol': {
            'dims': ['num_shortwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless'},
        'single_scattering_albedo_due_to_cloud': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless'},
        'single_scattering_albedo_due_to_aerosol': {
            'dims': ['num_shortwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless'},
        'cloud_asymmetry_parameter': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless'},
        'aerosol_asymmetry_parameter': {
            'dims': ['num_shortwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless'},
        'cloud_forward_scattering_fraction': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless'},
        'aerosol_optical_depth_at_55_micron': {
            'dims': ['num_ecmwf_aerosols', 'mid_levels', '*'],
            'units': 'dimensionless'},
        'solar_cycle_fraction': {'dims': [], 'units': 'dimensionless'},
        'flux_adjustment_for_earth_sun_distance': {
            'dims': [], 'units': 'dimensionless'},
    }

    tendency_properties = {
        'air_temperature': {'units': 'degK day^-1'},
    }

    diagnostic_properties = {
        'upwelling_shortwave_flux_in_air': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'downwelling_shortwave_flux_in_air': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'upwelling_shortwave_flux_in_air_assuming_clear_sky': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'downwelling_shortwave_flux_in_air_assuming_clear_sky': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'air_temperature_tendency_from_shortwave_assuming_clear_sky': {
            'dims': ['mid_levels', '*'], 'units': 'degK day^-1'},
        'air_temperature_tendency_from_shortwave': {
            'dims': ['mid_levels', '*'], 'units': 'degK day^-1'},
    }

    def __init__(self, cloud_overlap_method=None,
                 cloud_optical_properties='liquid_and_ice_clouds',
                 cloud_ice_properties='ebert_curry_two',
                 cloud_liquid_water_properties='radius_dependent_absorption',
                 mcica=False,
                 random_number_generator='mersenne_twister',
                 use_solar_constant_from_fortran=False,
                 ignore_day_of_year=False,
                 solar_variability_method=0,
                 facular_sunspot_amplitude=None,
                 solar_variability_by_band=None,
                 aerosol_type='no_aerosol',
                 device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        cloud_overlap_method = cloud_overlap_method or 'random'
        validate_mcica_options(
            mcica, cloud_overlap_method, cloud_optical_properties,
            cloud_ice_properties, cloud_liquid_water_properties,
            shortwave=True)
        self._cloud_overlap = rrtmg_cloud_overlap_method_dict[
            cloud_overlap_method.lower()]
        self._cloud_optics = rrtmg_cloud_props_dict[
            cloud_optical_properties.lower()]
        self._ice_props = rrtmg_cloud_ice_props_dict[
            cloud_ice_properties.lower()]
        self._liquid_props = rrtmg_cloud_liquid_props_dict[
            cloud_liquid_water_properties.lower()]
        self._mcica = mcica
        self._rng = rrtmg_random_number_dict[random_number_generator]
        self._aerosol_type = rrtmg_aerosol_input_dict[aerosol_type.lower()]
        self._solar_var_flag = solar_variability_method
        self._ignore_day_of_year = ignore_day_of_year
        if facular_sunspot_amplitude is None:
            facular_sunspot_amplitude = np.ones(2)
        self._fac_sunspot_coeff = tuple(
            float(v) for v in facular_sunspot_amplitude)
        self._solar_var_by_band = (
            None if solar_variability_by_band is None
            else tuple(float(v) for v in solar_variability_by_band))
        self._solar_const = (
            0.0 if use_solar_constant_from_fortran
            else float(get_constant('stellar_irradiance', 'W/m^2')))
        if self._cloud_optics == 1:
            logging.warning(
                "cloud_optical_properties 'single_cloud_type' is not "
                "supported by the shortwave scheme; using "
                "'liquid_and_ice_clouds' optics.")
        super().__init__(**kwargs)

    def array_call(self, raw_state):
        def a(name):
            return as_tensor(raw_state[name], self.device)

        def bands_last(name):
            return torch.movedim(a(name), 0, -1)

        model_time = raw_state.get('time')
        if self._ignore_day_of_year or model_time is None:
            day_of_year = 0
        else:
            day_of_year = model_time.timetuple().tm_yday
        solar_config = S.solar_variability(
            self._solar_var_flag, self._solar_const,
            float(raw_state['solar_cycle_fraction']),
            self._fac_sunspot_coeff, self._solar_var_by_band)
        fu, fd, fuc, fdc, hr, hrc = _sw_driver(
            a('air_pressure'), a('air_pressure_on_interface_levels'),
            a('air_temperature'),
            mass_to_volume_mixing_ratio(a('specific_humidity'), 18.02),
            a('mole_fraction_of_ozone_in_air'),
            a('mole_fraction_of_carbon_dioxide_in_air'),
            a('mole_fraction_of_methane_in_air'),
            a('mole_fraction_of_nitrous_oxide_in_air'),
            a('mole_fraction_of_oxygen_in_air'),
            a('surface_albedo_for_direct_shortwave'),
            a('surface_albedo_for_diffuse_shortwave'),
            a('surface_albedo_for_direct_near_infrared'),
            a('surface_albedo_for_diffuse_near_infrared'),
            torch.cos(a('zenith_angle')),
            a('cloud_area_fraction_in_atmosphere_layer'),
            a('shortwave_optical_thickness_due_to_cloud'),
            a('single_scattering_albedo_due_to_cloud'),
            a('cloud_asymmetry_parameter'),
            a('cloud_forward_scattering_fraction'),
            a('mass_content_of_cloud_ice_in_atmosphere_layer'),
            a('mass_content_of_cloud_liquid_water_in_atmosphere_layer'),
            a('cloud_ice_particle_size'), a('cloud_water_droplet_radius'),
            bands_last('shortwave_optical_thickness_due_to_aerosol'),
            bands_last('single_scattering_albedo_due_to_aerosol'),
            bands_last('aerosol_asymmetry_parameter'),
            a('aerosol_optical_depth_at_55_micron'),
            float(raw_state['flux_adjustment_for_earth_sun_distance']),
            float(get_constant('gravitational_acceleration', 'm/s^2')),
            float(get_constant('avogadro_constant', 'mole^-1')),
            float(get_constant(
                'heat_capacity_of_dry_air_at_constant_pressure',
                'J/kg/degK')),
            isolvar=self._solar_var_flag, icld=self._cloud_overlap,
            inflag=2 if self._cloud_optics == 1 else self._cloud_optics,
            iceflag=self._ice_props if self._ice_props > 0 else 1,
            liqflag=self._liquid_props, iaer=self._aerosol_type,
            day_of_year=day_of_year, solar_config=solar_config,
            generator=(per_call_generator(self._rng, self.device)
                       if self._mcica else None))
        diagnostics = {
            'upwelling_shortwave_flux_in_air': fu,
            'downwelling_shortwave_flux_in_air': fd,
            'upwelling_shortwave_flux_in_air_assuming_clear_sky': fuc,
            'downwelling_shortwave_flux_in_air_assuming_clear_sky': fdc,
            'air_temperature_tendency_from_shortwave': hr,
            'air_temperature_tendency_from_shortwave_assuming_clear_sky':
                hrc,
        }
        return {'air_temperature': hr}, diagnostics
