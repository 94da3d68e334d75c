"""RRTMGLongwave: 16-band, 140-g-point correlated-k longwave radiation
(climt_tpu/components/rrtmg/longwave.py).

The component computes on its ``device`` (the CUDA card unless the caller
asks for another) at the state's float type, float64 for
``get_default_state``'s state: inatm, setcoef, taumol (kernel-B groups),
cldprop and the Pade-table sweep of ``lw_spectral``.  McICA
(``mcica=True``) draws its subcolumns from a ``torch.Generator`` seeded
per call from numpy's global RNG, as the JAX component seeds its PRNG key;
``calculate_change_up_flux=True`` stores dF_up/dT_s on
``last_upward_flux_derivative[_clear_sky]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.base_components import TendencyComponent
from ...core.constants import get_constant
from ...core.dataarray import as_tensor
from ...core.util import (get_interface_values, mass_to_volume_mixing_ratio,
                          resolve_device)
from .common import (
    rrtmg_cloud_ice_props_dict, rrtmg_cloud_liquid_props_dict,
    rrtmg_cloud_overlap_method_dict, rrtmg_cloud_props_dict,
    rrtmg_random_number_dict, validate_mcica_options)
from .lw_spectral import NGB, cldprmc_lw, rrtmg_lw_fluxes
from .mcica import mcica_subcolumns


def per_call_generator(kind, device):
    """A torch.Generator on ``device`` seeded from numpy's global RNG, one
    draw per call: in [0, 1024) for KISS (kind 0), [0, 2**31 - 1) for the
    Mersenne twister (longwave.py:241-250, shortwave.py:296-305)."""
    high = 1024 if kind == 0 else 2 ** 31 - 1
    seed = int(np.random.randint(0, high))
    return torch.Generator(device=device).manual_seed(seed)


def _lw_radiation(play, plev, tlay, tlev, tsfc, h2ovmr, o3vmr, co2vmr,
                  ch4vmr, n2ovmr, o2vmr, cfc11vmr, cfc12vmr, cfc22vmr,
                  ccl4vmr, emis, cldfrac, taucld, ciwp, clwp, rei, rel,
                  tauaer, grav, avogad, cpdair, inflag, iceflag, liqflag,
                  icld, idrv, generator=None):
    """rrtmg_lw_fluxes with the component's cloud handling (:47): no
    clouds with icld 0, McICA subcolumns when a generator is given."""
    if icld == 0:
        cldfrac, taucld, ciwp, clwp = (torch.zeros_like(x) for x in (
            cldfrac, taucld, ciwp, clwp))
    common = dict(
        play=play, plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc,
        h2ovmr=h2ovmr, o3vmr=o3vmr, co2vmr=co2vmr, ch4vmr=ch4vmr,
        n2ovmr=n2ovmr, o2vmr=o2vmr, cfc11vmr=cfc11vmr, cfc12vmr=cfc12vmr,
        cfc22vmr=cfc22vmr, ccl4vmr=ccl4vmr, emis=emis, tauaer=tauaer,
        grav=grav, avogad=avogad, cpdair=cpdair, inflag=inflag,
        iceflag=iceflag, liqflag=liqflag, idrv=idrv, cldfrac=cldfrac,
        taucld=taucld, ciwp=ciwp, clwp=clwp, rei=rei, rel=rel)
    if generator is not None and icld != 0:
        cldfmc, ciwpmc, clwpmc, taucmc_in = mcica_subcolumns(
            generator, icld, cldfrac, ciwp, clwp, taucld, NGB)
        taucmc = cldprmc_lw(inflag, iceflag, liqflag, cldfmc, ciwpmc,
                            clwpmc, taucmc_in, rei, rel)
        return rrtmg_lw_fluxes(per_g_cloud=True, cldfrac_g=cldfmc,
                               taucld_g=taucmc, **common)
    return rrtmg_lw_fluxes(**common)


class RRTMGLongwave(TendencyComponent):
    """Longwave radiative transfer with the RRTMG interface."""

    num_longwave_bands = 16
    num_reduced_g_intervals = 140

    input_properties = {
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'mbar'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'mbar'},
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'specific_humidity': {'dims': ['mid_levels', '*'], 'units': 'g/g'},
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
        'mole_fraction_of_cfc11_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mole_fraction_of_cfc12_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mole_fraction_of_cfc22_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'mole_fraction_of_carbon_tetrachloride_in_air': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'surface_longwave_emissivity': {
            'dims': ['num_longwave_bands', '*'], 'units': 'dimensionless'},
        'cloud_area_fraction_in_atmosphere_layer': {
            'dims': ['mid_levels', '*'], 'units': 'dimensionless'},
        'longwave_optical_thickness_due_to_cloud': {
            'dims': ['mid_levels', '*', 'num_longwave_bands'],
            'units': 'dimensionless'},
        'mass_content_of_cloud_ice_in_atmosphere_layer': {
            'dims': ['mid_levels', '*'], 'units': 'g m^-2'},
        'mass_content_of_cloud_liquid_water_in_atmosphere_layer': {
            'dims': ['mid_levels', '*'], 'units': 'g m^-2'},
        'cloud_ice_particle_size': {
            'dims': ['mid_levels', '*'], 'units': 'micrometer'},
        'cloud_water_droplet_radius': {
            'dims': ['mid_levels', '*'], 'units': 'micrometer'},
        'longwave_optical_thickness_due_to_aerosol': {
            'dims': ['num_longwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless'},
    }

    tendency_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'],
                            'units': 'degK day^-1'},
    }

    diagnostic_properties = {
        'upwelling_longwave_flux_in_air': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'downwelling_longwave_flux_in_air': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'upwelling_longwave_flux_in_air_assuming_clear_sky': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'downwelling_longwave_flux_in_air_assuming_clear_sky': {
            'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
        'air_temperature_tendency_from_longwave_assuming_clear_sky': {
            'dims': ['mid_levels', '*'], 'units': 'degK day^-1'},
        'air_temperature_tendency_from_longwave': {
            'dims': ['mid_levels', '*'], 'units': 'degK day^-1'},
    }

    def __init__(self, calculate_change_up_flux=False,
                 cloud_overlap_method=None,
                 cloud_optical_properties='liquid_and_ice_clouds',
                 cloud_ice_properties='ebert_curry_two',
                 cloud_liquid_water_properties='radius_dependent_absorption',
                 calculate_interface_temperature=True,
                 mcica=False,
                 random_number_generator='mersenne_twister',
                 device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        cloud_overlap_method = cloud_overlap_method or 'random'
        validate_mcica_options(mcica, cloud_overlap_method,
                               cloud_optical_properties)
        self._cloud_overlap = rrtmg_cloud_overlap_method_dict[
            cloud_overlap_method.lower()]
        self._cloud_optics = rrtmg_cloud_props_dict[
            cloud_optical_properties.lower()]
        self._ice_props = rrtmg_cloud_ice_props_dict[
            cloud_ice_properties.lower()]
        self._liquid_props = rrtmg_cloud_liquid_props_dict[
            cloud_liquid_water_properties.lower()]
        self._mcica = mcica
        self._rng = rrtmg_random_number_dict[
            random_number_generator.lower()]
        self._calc_dflxdt = calculate_change_up_flux
        self._interface_t = calculate_interface_temperature
        #: (nz+1, ncol) dF_up/dT_s from the latest call, all-sky and
        #: clear-sky, when calculate_change_up_flux=True
        self.last_upward_flux_derivative = None
        self.last_upward_flux_derivative_clear_sky = None
        if not calculate_interface_temperature:
            self.input_properties = dict(self.input_properties)
            self.input_properties['air_temperature_on_interface_levels'] = {
                'dims': ['interface_levels', '*'], 'units': 'degK'}
        super().__init__(**kwargs)

    def _gather_inputs(self, raw_state):
        """rrtmg_lw_fluxes' inputs (a dict of tensors on the component's
        device, and the three constants) from the matched raw state;
        shared by array_call and the LW k-table calibration
        (climt_tpu_torch/tools/calibrate_lw_ktables.py)."""
        def a(name):
            return as_tensor(raw_state[name], self.device)

        def gas(name):
            return a('mole_fraction_of_%s_in_air' % name)

        play = a('air_pressure')
        plev = a('air_pressure_on_interface_levels')
        tlay = a('air_temperature')
        tsfc = a('surface_temperature')
        if self._interface_t:
            tlev = get_interface_values(tlay, tsfc, play, plev)
        else:
            tlev = a('air_temperature_on_interface_levels')
        return dict(
            play=play, plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc,
            # the reference converts with M=18.02 (longwave.py:198-201)
            h2ovmr=mass_to_volume_mixing_ratio(a('specific_humidity'),
                                               18.02),
            o3vmr=gas('ozone'), co2vmr=gas('carbon_dioxide'),
            ch4vmr=gas('methane'), n2ovmr=gas('nitrous_oxide'),
            o2vmr=gas('oxygen'), cfc11vmr=gas('cfc11'),
            cfc12vmr=gas('cfc12'), cfc22vmr=gas('cfc22'),
            ccl4vmr=gas('carbon_tetrachloride'),
            emis=a('surface_longwave_emissivity'),
            cldfrac=a('cloud_area_fraction_in_atmosphere_layer'),
            taucld=a('longwave_optical_thickness_due_to_cloud'),
            ciwp=a('mass_content_of_cloud_ice_in_atmosphere_layer'),
            clwp=a('mass_content_of_cloud_liquid_water_in_atmosphere_layer'),
            rei=a('cloud_ice_particle_size'),
            rel=a('cloud_water_droplet_radius'),
            tauaer=torch.movedim(
                a('longwave_optical_thickness_due_to_aerosol'), 0, -1),
            grav=get_constant('gravitational_acceleration', 'm/s^2'),
            avogad=get_constant('avogadro_constant', 'mole^-1'),
            cpdair=get_constant(
                'heat_capacity_of_dry_air_at_constant_pressure',
                'J/kg/degK'))

    def array_call(self, raw_state):
        out = _lw_radiation(
            inflag=self._cloud_optics, iceflag=self._ice_props,
            liqflag=self._liquid_props, icld=self._cloud_overlap,
            idrv=self._calc_dflxdt,
            generator=(per_call_generator(self._rng, self.device)
                       if self._mcica else None),
            **self._gather_inputs(raw_state))
        if self._calc_dflxdt:
            (self.last_upward_flux_derivative,
             self.last_upward_flux_derivative_clear_sky) = out[6:]
        up, down, hr, upc, downc, hrc = out[:6]
        diagnostics = {
            'upwelling_longwave_flux_in_air': up,
            'downwelling_longwave_flux_in_air': down,
            'upwelling_longwave_flux_in_air_assuming_clear_sky': upc,
            'downwelling_longwave_flux_in_air_assuming_clear_sky': downc,
            'air_temperature_tendency_from_longwave': hr,
            'air_temperature_tendency_from_longwave_assuming_clear_sky':
                hrc,
        }
        return {'air_temperature': hr}, diagnostics
