"""Named, units-aware, mutable physical-constants registry.

A copy of climt_tpu/core/constants.py: this package keeps its own
registry, which its ``__init__`` sets up the same way.

Mirrors the contract of the reference's constants system
(CliMT's climt/_core/constants.py:1-35 and the sympl
``get_constant``/``set_constant``/``reset_constants`` API): ~30 named
constants with units, read by every component, mutable by the user for
planetary experiments, resettable to defaults.

Values follow the sympl 0.4.1 defaults the reference pins (setup.py:43) so
that golden regression outputs match; the reference additionally overrides
``top_of_model_pressure`` to 20 Pa at import (climt/__init__.py:18), which we
reproduce in the package __init__.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .units import convert

# name -> (value, units)
_DEFAULT_CONSTANTS: Dict[str, Tuple[float, str]] = {
    # -- universal / planetary ------------------------------------------------
    'stefan_boltzmann_constant': (5.670367e-8, 'W m^-2 K^-4'),
    'gravitational_acceleration': (9.80665, 'm s^-2'),
    'planetary_radius': (6.371e6, 'm'),
    'planetary_rotation_rate': (7.292e-5, 's^-1'),
    'seconds_per_day': (86400., 'dimensionless'),
    'avogadro_constant': (6.022140857e23, 'mole^-1'),
    'boltzmann_constant': (1.38064852e-23, 'J K^-1'),
    'loschmidt_constant': (2.6516467e25, 'm^-3'),
    'universal_gas_constant': (8.3144598, 'J mole^-1 K^-1'),
    'speed_of_light': (299792458., 'm s^-1'),
    'planck_constant': (6.62607004e-34, 'J s'),

    # -- solar ---------------------------------------------------------------
    'solar_constant': (1367., 'W m^-2'),
    'stellar_irradiance': (1367., 'W m^-2'),

    # -- dry air -------------------------------------------------------------
    'heat_capacity_of_dry_air_at_constant_pressure': (1004.64, 'J kg^-1 K^-1'),
    'gas_constant_of_dry_air': (287., 'J kg^-1 K^-1'),
    'thermal_conductivity_of_dry_air': (0.026, 'W m^-1 K^-1'),
    'reference_air_pressure': (1.0132e5, 'Pa'),
    'reference_air_temperature': (300., 'degK'),

    # -- water in all phases -------------------------------------------------
    'gas_constant_of_vapor_phase': (461.5, 'J kg^-1 K^-1'),
    'heat_capacity_of_vapor_phase': (1846., 'J kg^-1 K^-1'),
    'specific_enthalpy_of_vapor_phase': (2500., 'J kg^-1'),
    'latent_heat_of_condensation': (2.5e6, 'J kg^-1'),
    'latent_heat_of_vaporization': (2.5e6, 'J kg^-1'),
    'latent_heat_of_fusion': (333550., 'J kg^-1'),
    'von_karman_constant': (0.4, 'dimensionless'),
    'heat_capacity_of_sea_water': (3985.0, 'J kg^-1 degK^-1'),
    'freezing_temperature_of_liquid_phase': (273., 'degK'),
    'density_of_liquid_phase': (1e3, 'kg m^-3'),
    'density_of_liquid_water': (1e3, 'kg m^-3'),
    'heat_capacity_of_liquid_phase': (4185.5, 'J kg^-1 K^-1'),
    'thermal_conductivity_of_liquid_phase': (0.57, 'W m^-1 K^-1'),
    'density_of_solid_phase_as_ice': (916.7, 'kg m^-3'),
    'density_of_solid_phase_as_snow': (100., 'kg m^-3'),
    'heat_capacity_of_solid_phase_as_ice': (2108., 'J kg^-1 K^-1'),
    'heat_capacity_of_solid_phase_as_snow': (2108., 'J kg^-1 K^-1'),
    'thermal_conductivity_of_solid_phase_as_ice': (2.22, 'W m^-1 K^-1'),
    'thermal_conductivity_of_solid_phase_as_snow': (0.2, 'W m^-1 K^-1'),
}

_CONDENSIBLE_EXTRA = {
    'density', 'heat_capacity', 'thermal_conductivity',
    'specific_enthalpy', 'gas_constant',
}

_constants: Dict[str, Tuple[float, str]] = dict(_DEFAULT_CONSTANTS)


class ConstantNotFoundError(KeyError):
    pass


def get_constant(name: str, units: str) -> float:
    """Return the value of a named constant in the requested units."""
    try:
        value, stored_units = _constants[name]
    except KeyError:
        raise ConstantNotFoundError(
            'No constant named {!r} in the registry'.format(name))
    return convert(value, stored_units, units)


def set_constant(name: str, value: float, units: str) -> None:
    """Set (or create) a named constant."""
    _constants[name] = (float(value), units)


def reset_constants() -> None:
    """Restore all constants to their default values."""
    _constants.clear()
    _constants.update(_DEFAULT_CONSTANTS)


def set_constants_from_dict(constant_descriptions: dict) -> None:
    """Set many constants at once from {name: {'value': v, 'units': u}}."""
    for name, desc in constant_descriptions.items():
        set_constant(name, desc['value'], desc['units'])


def list_available_constants() -> None:
    """Print all constants currently registered."""
    print(get_constants_string())


def get_constants_string() -> str:
    lines = []
    for name in sorted(_constants):
        value, units = _constants[name]
        lines.append('{}: {} {}'.format(name, value, units))
    return '\n'.join(lines)


def constant_names():
    return tuple(_constants.keys())
