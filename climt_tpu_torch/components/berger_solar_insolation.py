"""Berger (1978) orbital solution and solar insolation
(climt_tpu/components/berger_solar_insolation.py).

The obliquity, eccentricity and general-precession series of CAM3's
shr_orb_mod (term tables in ``data.BERGER``) stay numpy on the host,
evaluated once per calendar year and cached, as in JAX (:46-108); the
mean/true longitude expansion, earth-sun distance and declination are
host scalar maths; only the (lat, lon) -> (insolation, zenith) map
(:111-127) runs on ``device``, at the state's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import data
from ..core.base_components import DiagnosticComponent
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device

_ARCSEC_TO_DEG = 1.0 / 3600.0


def get_orbital_parameters(years_since_1950):
    """(lambda_m0, eccentricity, omega_tilde, obliquity) per Berger 1978
    (:46): trigonometric series in time with tabulated amplitudes, rates
    and phases."""
    tab = data.load_numpy(data.BERGER)
    t = float(years_since_1950)

    # Equation 1: obliquity
    obliquity = 23.320556 + np.sum(
        tab['obliquity_amp'] * _ARCSEC_TO_DEG * np.cos(
            np.deg2rad(tab['obliquity_rate'] * _ARCSEC_TO_DEG * t
                       + tab['obliquity_phase'])))
    obliquity = math.radians(obliquity)

    # Equations 2-3: eccentricity from the e*cos(pi), e*sin(pi) series
    # (the argument is used in radians without a deg2rad conversion, as
    # the reference does)
    arg = tab['ecc_rate'] * _ARCSEC_TO_DEG * t + tab['ecc_phase']
    cos_sum = float(np.sum(tab['ecc_amp'] * np.cos(arg)))
    sin_sum = float(np.sum(tab['ecc_amp'] * np.sin(arg)))
    eccentricity_squared = cos_sum ** 2 + sin_sum ** 2
    eccentricity = math.sqrt(eccentricity_squared)

    # Equation 4: fixed-vernal-equinox longitude of perihelion
    if abs(cos_sum) < 1e-8:
        if sin_sum == 0.:
            lon_perihelion = 0.
        elif sin_sum < 0.:
            lon_perihelion = 1.5 * math.pi
        else:
            lon_perihelion = 0.5 * math.pi
    elif cos_sum < 0.:
        lon_perihelion = math.atan(sin_sum / cos_sum) + math.pi
    elif sin_sum < 0.:
        lon_perihelion = math.atan(sin_sum / cos_sum) + 2. * math.pi
    else:
        lon_perihelion = math.atan(sin_sum / cos_sum)

    # Equation 6: moving-vernal-equinox longitude of perihelion
    omega_tilde = (math.degrees(lon_perihelion)
                   + 50.439273 * _ARCSEC_TO_DEG * t + 3.392506)
    omega_tilde += np.sum(tab['mvelp_amp'] * np.sin(
        np.deg2rad(tab['mvelp_rate'] * _ARCSEC_TO_DEG * t
                   + tab['mvelp_phase'])))
    omega_tilde = omega_tilde % 360.0
    omega_tilde = math.radians(omega_tilde)

    beta = math.sqrt(1 - eccentricity_squared)
    ecc3 = eccentricity * eccentricity_squared
    # mean longitude at vernal equinox (Berger 1978, p. 2365)
    lambda_m0 = 2. * (
        (0.5 * eccentricity + 0.125 * ecc3) * (1. + beta)
        * math.sin(omega_tilde + math.pi)
        - 0.25 * eccentricity_squared * (0.5 + beta)
        * math.sin(2 * (omega_tilde + math.pi))
        + 0.125 * ecc3 * (1. / 3. + beta)
        * math.sin(3 * (omega_tilde + math.pi)))
    return lambda_m0, eccentricity, omega_tilde, obliquity


def _insolation_map(lat, lon, fractional_day, sin_delta, cos_delta,
                    inverse_rho_squared, solar_constant,
                    degrees_as_radians_compat=False):
    """(insolation, zenith) of (lat, lon) tensors in degrees (:112)."""
    hour_angle = 2 * math.pi * (fractional_day + lon / 360.0)
    # the compat flag reproduces the reference's quirk of feeding latitude
    # in degrees straight into sin/cos; physically wrong off the equator
    lat_rad = lat if degrees_as_radians_compat else torch.deg2rad(lat)
    cos_mu = (torch.sin(lat_rad) * sin_delta
              - torch.cos(lat_rad) * cos_delta * torch.cos(hour_angle))
    zenith = torch.arccos(cos_mu)
    insolation = solar_constant * inverse_rho_squared * cos_mu
    return insolation, zenith


def get_solar_parameters(lambda_m0, eccentricity, omega_tilde, obliquity,
                         years_since_vernal_equinox, fractional_day,
                         lat_deg, lon_deg, solar_constant,
                         degrees_as_radians_compat=False):
    """Insolation and zenith angle at every grid point (:130)."""
    lambda_m = lambda_m0 + years_since_vernal_equinox * 2. * math.pi
    temp = lambda_m - (omega_tilde + math.pi)
    sin_temp = math.sin(temp)
    # true longitude from mean longitude (3rd-order equation of centre)
    lmbda = lambda_m + eccentricity * (
        2. * sin_temp + eccentricity * (
            1.25 * math.sin(2 * temp) + eccentricity * (
                (13. / 12.) * math.sin(3 * temp) - 0.25 * sin_temp)))
    inverse_rho = (1 + eccentricity * math.cos(
        lmbda - (omega_tilde + math.pi))) / (1 - eccentricity ** 2)
    rho = 1. / inverse_rho
    declination = math.asin(math.sin(obliquity) * math.sin(lmbda))
    insolation, zenith = _insolation_map(
        lat_deg, lon_deg, fractional_day, math.sin(declination),
        math.cos(declination), inverse_rho ** 2, solar_constant,
        degrees_as_radians_compat)
    return insolation, zenith, obliquity, eccentricity, rho


def years_since_vernal_equinox(dt):
    """Fractional years since March 20, noon UTC of the current year."""
    year_start = type(dt)(dt.year, 3, 20, 12)
    year_end = type(dt)(dt.year + 1, 3, 20, 12)
    return ((dt - year_start).total_seconds()
            / (year_end - year_start).total_seconds())


def fractional_day(dt):
    day_start = type(dt)(dt.year, dt.month, dt.day)
    return (dt - day_start).total_seconds() / 86400.


class BergerSolarInsolation(DiagnosticComponent):
    """Solar insolation from the Berger 1978 orbital solution (CAM3)
    (:167), on ``device`` (the CUDA card unless the caller asks for
    another).  The scalar outputs are host floats, as in JAX."""

    input_properties = {
        'longitude': {'dims': ['*'], 'units': 'degrees_east'},
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
    }

    diagnostic_properties = {
        'solar_insolation': {'dims': ['*'], 'units': 'W m^-2'},
        'solar_zenith_angle': {'dims': ['*'], 'units': 'radians'},
        'obliquity': {'dims': [], 'units': 'radians'},
        'eccentricity': {'dims': [], 'units': 'radians'},
        'normalized_earth_sun_distance': {'dims': [],
                                          'units': 'dimensionless'},
    }

    def __init__(self, degrees_as_radians_compat=False, device='cuda',
                 **kwargs):
        """``degrees_as_radians_compat=True`` reproduces the reference's
        latitude-unit bug for regression validation (see
        _insolation_map)."""
        self.device = resolve_device(device)
        self._orbital_parameters = {}
        self._compat = degrees_as_radians_compat
        super().__init__(**kwargs)

    def array_call(self, state):
        time = state['time']
        year = time.year
        if year not in self._orbital_parameters:
            self._orbital_parameters[year] = get_orbital_parameters(
                float(year - 1950))
        insolation, zenith, obliquity, eccentricity, rho = \
            get_solar_parameters(
                *self._orbital_parameters[year],
                years_since_vernal_equinox(time), fractional_day(time),
                as_tensor(state['latitude'], self.device),
                as_tensor(state['longitude'], self.device),
                get_constant('stellar_irradiance', 'W/m^2'), self._compat)
        return {
            'solar_insolation': insolation,
            'solar_zenith_angle': zenith,
            'obliquity': obliquity,
            'eccentricity': eccentricity,
            'normalized_earth_sun_distance': rho,
        }
