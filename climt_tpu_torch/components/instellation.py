"""Astronomical solar zenith angle (climt_tpu/components/instellation.py).

Zenith angle from the model time and lat/lon via Greenwich mean sidereal
time, the sun's ecliptic longitude (Meeus low-precision series),
obliquity, and the right-ascension/declination -> hour-angle -> zenith
chain; clamped to [-pi/2, pi/2].  The per-timestamp orbital scalars are
host Python floats, as in JAX (:25-75); only the (lat, lon) -> zenith map
runs on ``device``, at the state's dtype.
"""

from __future__ import annotations

import datetime
import math

import torch

from ..core.base_components import DiagnosticComponent
from ..core.dataarray import as_tensor
from ..core.util import resolve_device


def days_from_2000(model_time):
    delta = model_time - datetime.datetime(2000, 1, 1, 12, 0)
    return delta.days + (delta.seconds + delta.microseconds / 1e6) / 86400.0


def greenwich_mean_sidereal_time(model_time):
    """GMST in radians (AIAA 2006 implementation) (:30)."""
    jc = days_from_2000(model_time) / 36525.0
    theta = 67310.54841 + jc * (
        876600 * 3600 + 8640184.812866 + jc * (0.093104 - jc * 6.2e-5))
    theta_radians = math.radians(theta / 240.0) % (2 * math.pi)
    if theta_radians < 0:
        theta_radians += 2 * math.pi
    return theta_radians


def sun_ecliptic_longitude(model_time):
    """True ecliptic longitude of the sun (Meeus low-precision) (:41)."""
    jc = days_from_2000(model_time) / 36525.0
    mean_anomaly = math.radians(
        357.52910 + 35999.05030 * jc - 0.0001559 * jc ** 2
        - 0.00000048 * jc ** 3)
    mean_longitude = math.radians(
        280.46645 + 36000.76983 * jc + 0.0003032 * jc ** 2)
    d_l = math.radians(
        (1.914600 - 0.004817 * jc - 0.000014 * jc ** 2)
        * math.sin(mean_anomaly)
        + (0.019993 - 0.000101 * jc) * math.sin(2 * mean_anomaly)
        + 0.000290 * math.sin(3 * mean_anomaly))
    return mean_longitude + d_l


def obliquity_star(julian_centuries):
    jc = julian_centuries
    return math.radians(
        23.0 + 26.0 / 60 + 21.406 / 3600.0 -
        (46.836769 * jc - 0.0001831 * jc ** 2 + 0.00200340 * jc ** 3
         - 0.576e-6 * jc ** 4 - 4.34e-8 * jc ** 5) / 3600.)


def right_ascension_declination(model_time):
    jc = days_from_2000(model_time) / 36525.0
    eps = obliquity_star(jc)
    eclon = sun_ecliptic_longitude(model_time)
    x = math.cos(eclon)
    y = math.cos(eps) * math.sin(eclon)
    z = math.sin(eps) * math.sin(eclon)
    r = math.sqrt(1.0 - z * z)
    declination = math.atan2(z, r)
    right_ascension = 2 * math.atan2(y, (x + r))
    return right_ascension, declination


def zenith_from_angles(lat, lon, gmst, right_ascension, declination):
    """Zenith angle of (lat, lon) tensors in radians (:79)."""
    hour_angle = gmst + lon - right_ascension
    zenith = torch.arccos(
        torch.sin(lat) * math.sin(declination)
        + torch.cos(lat) * math.cos(declination) * torch.cos(hour_angle))
    return torch.clamp(zenith, -math.pi / 2, math.pi / 2)


def sun_zenith_angle(model_time, lon, lat):
    """Solar zenith angle (radians) of lon/lat tensors in radians (:87)."""
    ra, dec = right_ascension_declination(model_time)
    gmst = greenwich_mean_sidereal_time(model_time)
    return zenith_from_angles(lat, lon, gmst, ra, dec)


class Instellation(DiagnosticComponent):
    """Diagnose the solar zenith angle from time, latitude and longitude
    (:95), on ``device`` (the CUDA card unless the caller asks for
    another)."""

    input_properties = {
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
        'longitude': {'dims': ['*'], 'units': 'degrees_east'},
    }

    diagnostic_properties = {
        'zenith_angle': {'dims': ['*'], 'units': 'radians'},
    }

    def __init__(self, device='cuda', **kwargs):
        self.device = resolve_device(device)
        super().__init__(**kwargs)

    def array_call(self, state):
        return {'zenith_angle': sun_zenith_angle(
            state['time'],
            torch.deg2rad(as_tensor(state['longitude'], self.device)),
            torch.deg2rad(as_tensor(state['latitude'], self.device)))}
