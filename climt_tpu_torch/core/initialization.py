"""Default-state construction (climt_tpu/core/initialization.py).

``get_default_state`` returns numpy-backed DataArrays, as the JAX one does;
the state reaches a device at the first component call.

Behavioral parity with CliMT's climt/_core/initialization.py:
- a table of ~55 default quantities with value/units/domain (:683-756),
- per-domain shape resolution (atmosphere / surface / land / ocean / ice /
  scalar, with horizontal/interface variants, :12-87),
- pressure-function initial diagnostics (ozone cubic spline from the packaged
  profile, Frierson grey optical depth, :848-872),
- ``get_default_state``: aggregate component ``input_properties``, find an
  initializer for every missing quantity, fill the state (:820-845).
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline

from .. import data
from .base_components import DiagnosticComponent
from .dataarray import DataArray
from .grid import get_grid
from .properties import combine_component_properties

# -- spectral band-count hooks -------------------------------------------------
# Radiation schemes declare their band counts at construction so that the
# num_longwave_bands / num_shortwave_bands dimensions of default-value
# initializers (emissivity, cloud optics) match the active scheme
# (reference _core/initialization.py set_num_longwave_bands, v0.31).

_num_longwave_bands = None      # None -> RRTMG default (16)
_num_shortwave_bands = None     # None -> RRTMG default (14)


def set_num_longwave_bands(n):
    global _num_longwave_bands
    _num_longwave_bands = int(n)


def set_num_shortwave_bands(n):
    global _num_shortwave_bands
    _num_shortwave_bands = int(n)


def get_num_longwave_bands():
    return 16 if _num_longwave_bands is None else _num_longwave_bands


def get_num_shortwave_bands():
    return 14 if _num_shortwave_bands is None else _num_shortwave_bands


# -- domain shape resolution --------------------------------------------------

def _atmosphere_shape(grid_state, interface=False, horizontal=False):
    ny, nx = grid_state['latitude'].shape
    y_dim, x_dim = grid_state['latitude'].dims
    nzi = grid_state[
        'atmosphere_hybrid_sigma_pressure_a_coordinate_on_interface_levels'
    ].shape[0]
    if horizontal:
        return (ny, nx), (y_dim, x_dim)
    if interface:
        return (nzi, ny, nx), ('interface_levels', y_dim, x_dim)
    return (nzi - 1, ny, nx), ('mid_levels', y_dim, x_dim)


def _surface_shape(grid_state, interface=False, horizontal=False):
    return (tuple(grid_state['latitude'].shape),
            tuple(grid_state['latitude'].dims))


def _land_shape(grid_state, interface=False, horizontal=False):
    if not horizontal:
        raise NotImplementedError('3D land grids are not yet supported')
    return (tuple(grid_state['latitude'].shape),
            tuple(grid_state['latitude'].dims))


_ocean_shape = _land_shape


def _soil_shape(grid_state, interface=False, horizontal=False):
    ny, nx = grid_state['latitude'].shape
    y_dim, x_dim = grid_state['latitude'].dims
    nzs = grid_state['height_on_soil_interface_levels'].shape[0]
    if horizontal:
        return (ny, nx), (y_dim, x_dim)
    if interface:
        return (nzs, ny, nx), ('soil_interface_levels', y_dim, x_dim)
    return (nzs - 1, ny, nx), ('soil_mid_levels', y_dim, x_dim)


def _ice_shape(grid_state, interface=False, horizontal=False):
    ny, nx = grid_state['latitude'].shape
    y_dim, x_dim = grid_state['latitude'].dims
    nzi = grid_state['height_on_ice_interface_levels'].shape[0]
    if horizontal:
        return (ny, nx), (y_dim, x_dim)
    if interface:
        return (nzi, ny, nx), ('ice_interface_levels', y_dim, x_dim)
    return (nzi - 1, ny, nx), ('ice_mid_levels', y_dim, x_dim)


def _scalar_shape(grid_state, interface=False, horizontal=False):
    return (), ()


_DOMAIN_SHAPES = {
    'atmosphere': _atmosphere_shape,
    'surface': _surface_shape,
    'land': _land_shape,
    'ocean': _ocean_shape,
    'ice': _ice_shape,
    'soil': _soil_shape,
    'scalar': _scalar_shape,
}


# -- the default-value table --------------------------------------------------

default_values = {
    'air_temperature': {'value': 290., 'units': 'degK', 'domain': 'atmosphere'},
    'northward_wind': {'value': 0., 'units': 'm/s', 'domain': 'atmosphere'},
    'eastward_wind': {'value': 0., 'units': 'm/s', 'domain': 'atmosphere'},
    'divergence_of_wind': {'value': 0., 'units': 's^-1', 'domain': 'atmosphere'},
    'atmosphere_relative_vorticity': {'value': 0., 'units': 's^-1', 'domain': 'atmosphere'},
    'specific_humidity': {'value': 0., 'units': 'kg/kg', 'domain': 'atmosphere'},
    'mole_fraction_of_carbon_dioxide_in_air': {'value': 330e-6, 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_methane_in_air': {'value': 0., 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_nitrous_oxide_in_air': {'value': 0., 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_oxygen_in_air': {'value': 0.21, 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_nitrogen_in_air': {'value': 0.78, 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_hydrogen_in_air': {'value': 500e-9, 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_cfc11_in_air': {'value': 0., 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_cfc12_in_air': {'value': 0., 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_cfc22_in_air': {'value': 0., 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mole_fraction_of_carbon_tetrachloride_in_air': {'value': 0., 'units': 'dimensionless', 'domain': 'atmosphere'},
    'cloud_area_fraction_in_atmosphere_layer': {'value': 0., 'units': 'dimensionless', 'domain': 'atmosphere'},
    'mass_content_of_cloud_ice_in_atmosphere_layer': {'value': 0., 'units': 'kg m^-2', 'domain': 'atmosphere'},
    'mass_content_of_cloud_liquid_water_in_atmosphere_layer': {'value': 0., 'units': 'kg m^-2', 'domain': 'atmosphere'},
    'cloud_ice_particle_size': {'value': 20., 'units': 'micrometer', 'domain': 'atmosphere'},
    'cloud_water_droplet_radius': {'value': 10., 'units': 'micrometer', 'domain': 'atmosphere'},
    'cloud_base_mass_flux': {'value': 0., 'units': 'kg m^-2 s^-1', 'domain': 'atmosphere_horizontal'},
    'zenith_angle': {'value': 0., 'units': 'radians', 'domain': 'atmosphere_horizontal'},
    'downwelling_shortwave_flux_in_air': {'value': 0., 'units': 'W m^-2', 'domain': 'atmosphere_interface'},
    'downwelling_longwave_flux_in_air': {'value': 0., 'units': 'W m^-2', 'domain': 'atmosphere_interface'},
    'upwelling_shortwave_flux_in_air': {'value': 0., 'units': 'W m^-2', 'domain': 'atmosphere_interface'},
    'upwelling_longwave_flux_in_air': {'value': 0., 'units': 'W m^-2', 'domain': 'atmosphere_interface'},

    'surface_specific_humidity': {'value': 0., 'units': 'kg/kg', 'domain': 'surface'},
    'surface_temperature': {'value': 300., 'units': 'degK', 'domain': 'surface'},
    'soil_surface_temperature': {'value': 300., 'units': 'degK', 'domain': 'surface'},
    'surface_geopotential': {'value': 0., 'units': 'm^2 s^-2', 'domain': 'surface'},
    'surface_thermal_capacity': {'value': 4.1813e3, 'units': 'J kg^-1 degK^-1', 'domain': 'surface'},
    'depth_of_slab_surface': {'value': 50., 'units': 'm', 'domain': 'surface'},
    'surface_material_density': {'value': 1000., 'units': 'kg m^-3', 'domain': 'surface'},
    'surface_albedo_for_direct_shortwave': {'value': 0.06, 'units': 'dimensionless', 'domain': 'surface'},
    'surface_albedo_for_diffuse_shortwave': {'value': 0.06, 'units': 'dimensionless', 'domain': 'surface'},
    'surface_albedo_for_direct_near_infrared': {'value': 0.06, 'units': 'dimensionless', 'domain': 'surface'},
    'surface_albedo_for_diffuse_near_infrared': {'value': 0.06, 'units': 'dimensionless', 'domain': 'surface'},
    'surface_roughness_length': {'value': 0.0002, 'units': 'dimensionless', 'domain': 'surface'},
    'surface_drag_coefficient_for_heat_in_air': {'value': 0.0012, 'units': 'dimensionless', 'domain': 'surface'},
    'surface_drag_coefficient_for_momentum_in_air': {'value': 0.0012, 'units': 'dimensionless', 'domain': 'surface'},
    'area_type': {'value': 'sea', 'units': 'dimensionless', 'dtype': 'U100', 'domain': 'surface'},
    'surface_upward_sensible_heat_flux': {'value': 0., 'units': 'W m^-2', 'domain': 'surface'},
    'surface_upward_latent_heat_flux': {'value': 0., 'units': 'W m^-2', 'domain': 'surface'},
    'surface_downward_eastward_stress': {'value': 0., 'units': 'N m^-2', 'domain': 'surface'},
    'surface_downward_northward_stress': {'value': 0., 'units': 'N m^-2', 'domain': 'surface'},

    'soil_type': {'value': 'clay', 'units': 'dimensionless', 'dtype': 'U100', 'domain': 'land_horizontal'},
    'soil_temperature': {'value': 285., 'units': 'degK', 'domain': 'soil_interface'},
    'soil_liquid_water_content': {'value': 0.2, 'units': 'm^3/m^3', 'domain': 'soil_interface'},
    'soil_ice_content': {'value': 0., 'units': 'm^3/m^3', 'domain': 'soil_interface'},
    'soil_layer_thickness': {'value': 50., 'units': 'm', 'domain': 'land_horizontal'},
    'upward_heat_flux_at_ground_level_in_soil': {'value': 0., 'units': 'W m^-2', 'domain': 'land_horizontal'},
    'heat_capacity_of_soil': {'value': 2000., 'units': 'J kg^-1 degK^-1', 'domain': 'land_horizontal'},
    'deep_soil_moisture_content': {'value': 0.25, 'units': 'm', 'domain': 'land_horizontal'},
    'deep_soil_temperature': {'value': 285., 'units': 'degK', 'domain': 'land_horizontal'},
    'runoff_rate': {'value': 0., 'units': 'm s^-1', 'domain': 'land_horizontal'},

    'sea_water_density': {'value': 1.029e3, 'units': 'kg m^-3', 'domain': 'ocean_horizontal'},
    'sea_surface_temperature': {'value': 300., 'units': 'degK', 'domain': 'ocean_horizontal'},
    'ocean_mixed_layer_thickness': {'value': 50., 'units': 'm', 'domain': 'ocean_horizontal'},
    'ocean_heat_transport_convergence': {'value': 0., 'units': 'W m^-2', 'domain': 'ocean_horizontal'},

    'snow_and_ice_temperature': {'value': 270., 'units': 'degK', 'domain': 'ice_interface'},
    'heat_flux_into_sea_water_due_to_sea_ice': {'value': 0., 'units': 'W m^-2', 'domain': 'ice_horizontal'},
    'land_ice_thickness': {'value': 0., 'units': 'm', 'domain': 'ice_horizontal'},
    'sea_ice_thickness': {'value': 0., 'units': 'm', 'domain': 'ice_horizontal'},
    'surface_snow_thickness': {'value': 0., 'units': 'm', 'domain': 'ice_horizontal'},

    'solar_cycle_fraction': {'value': 0., 'units': 'dimensionless', 'domain': None},
    'flux_adjustment_for_earth_sun_distance': {'value': 1.0, 'units': 'dimensionless', 'domain': None},
    'lwe_thickness_of_soil_moisture_content': {'value': 0, 'units': 'm', 'domain': 'surface'},
    'convective_precipitation_rate': {'value': 0., 'units': 'mm day^-1', 'domain': 'surface'},
    'stratiform_precipitation_rate': {'value': 0., 'units': 'm s^-1', 'domain': 'surface'},
    'irradiation_temperature': {'value': 0., 'units': 'degK', 'domain': 'atmosphere_horizontal'},
    'internal_temperature': {'value': 0., 'units': 'degK', 'domain': 'atmosphere_horizontal'},
}


class ConstantDefaultValue:
    """Broadcasts a constant default to its domain's shape as a DataArray."""

    def __init__(self, output_name, output_value, output_units,
                 dtype=None, domain=None):
        self._name = output_name
        self._value = output_value
        self._units = output_units
        self._dtype = np.float64 if dtype is None else np.dtype(dtype)
        self._interface = False
        self._horizontal = False
        if domain is None:
            self._domain = 'scalar'
        else:
            parts = domain.split('_')
            self._domain = parts[0]
            if len(parts) > 1:
                if parts[1] == 'horizontal':
                    self._horizontal = True
                elif parts[1] == 'interface':
                    self._interface = True
                else:
                    raise NotImplementedError(
                        'Unknown domain descriptor {}'.format(domain))
        self.diagnostic_properties = {
            output_name: {'dims': ['*'], 'units': output_units}}

    def __call__(self, grid_state):
        shape, dims = _DOMAIN_SHAPES[self._domain](
            grid_state, self._interface, self._horizontal)
        values = np.broadcast_to(
            np.array(self._value, dtype=self._dtype), shape).copy()
        return {self._name: DataArray(
            values, dims=dims, attrs={'units': self._units},
            name=self._name)}


class PressureFunctionDiagnosticComponent(DiagnosticComponent):
    """Defines a quantity as a function of (pressure, surface pressure)."""

    diagnostic_properties = {}

    def __init__(self, output_name, output_function, output_units,
                 mid_or_interface_levels='mid'):
        if mid_or_interface_levels == 'interface':
            vertical_dim = 'interface_levels'
            output_name = output_name + '_on_interface_levels'
            pressure_name = 'air_pressure_on_interface_levels'
        elif mid_or_interface_levels == 'mid':
            vertical_dim = 'mid_levels'
            pressure_name = 'air_pressure'
        else:
            raise ValueError(
                "mid_or_interface_levels must be 'mid' or 'interface'")
        self.input_properties = {
            pressure_name: {
                'dims': [vertical_dim, '*'], 'units': 'Pa', 'alias': 'p'},
            'surface_air_pressure': {
                'dims': ['*'], 'units': 'Pa', 'alias': 'ps'},
        }
        self.diagnostic_properties = {
            output_name: {'dims': [vertical_dim, '*'],
                          'units': output_units},
        }
        self._output_function = output_function
        self._output_name = output_name
        super().__init__()

    def array_call(self, raw_state):
        return {self._output_name: self._output_function(
            raw_state['p'], raw_state['ps'])}


def init_ozone(p, ps):
    """Cubic-spline interpolation of the packaged climatological ozone
    profile (mole/mole) onto the model pressure levels."""
    p_ref = 1e5 * np.linspace(0.998, 0.001, 30)
    ozone_ref = data.load_numpy(data.OZONE)
    spline = CubicSpline(p_ref[::-1], ozone_ref[::-1])
    return spline(np.asarray(p))


def _frierson_tau(p, ps):
    return 1.0 * (1.0 - p / ps[None, :])


def _standard_init_diagnostics():
    from ..components.rrtmg.defaults import (
        RRTMGLongwaveDefaultValues, RRTMGShortwaveDefaultValues)
    return [
        PressureFunctionDiagnosticComponent(
            'longwave_optical_depth', _frierson_tau, 'dimensionless',
            'interface'),
        PressureFunctionDiagnosticComponent(
            'mole_fraction_of_ozone_in_air', init_ozone, 'mole/mole', 'mid'),
        RRTMGShortwaveDefaultValues(),
        RRTMGLongwaveDefaultValues(),
    ]


def get_init_diagnostic(name):
    """Return an initializer component that can produce quantity ``name``."""
    if name in default_values:
        entry = default_values[name]
        return ConstantDefaultValue(
            name, entry['value'], entry['units'],
            dtype=entry.get('dtype'), domain=entry['domain'])
    if name.endswith('_on_interface_levels') and name[:-20] in default_values:
        entry = default_values[name[:-20]]
        return ConstantDefaultValue(
            name, entry['value'], entry['units'],
            dtype=entry.get('dtype'),
            domain=entry['domain'] + '_interface')
    for diag in _standard_init_diagnostics():
        if name in diag.diagnostic_properties:
            return diag
    raise NotImplementedError(
        'No initialization method for quantity name {}'.format(name))


def aggregate_input_properties(component_list):
    return combine_component_properties(component_list, 'input_properties')


def get_default_state(component_list, grid_state=None,
                      n_ice_interface_levels=30):
    """Build a reasonable initial state for the given components."""
    grid_state = grid_state or get_grid(
        n_ice_interface_levels=n_ice_interface_levels)
    input_properties = aggregate_input_properties(component_list)
    state = {}
    state.update(grid_state)
    for name in input_properties:
        if name in state:
            continue
        diag = get_init_diagnostic(name)
        output = diag(grid_state)
        state.update(output)
    return state
