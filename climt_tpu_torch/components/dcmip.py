"""DCMIP (2012) idealized initial conditions, tests 4 and 5
(climt_tpu/components/dcmip.py).

The Jablonowski-Williamson baroclinic wave (with or without its
perturbation, dry or moist) and the Reed-Jablonowski analytic tropical
cyclone, as whole-grid tensor expressions on ``device``.  The cyclone's
20 fixed Newton steps of the height (JAX's ``lax.scan``, :163-167) are a
Python loop; the baroclinic wave's ``static_argnums`` flags (:77) are
Python bools.  Physical constants are the DCMIP-prescribed values of the
reference Fortran, not the registry's.
"""

from __future__ import annotations

import math

import torch

from ..core.base_components import DiagnosticComponent
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device

# DCMIP-prescribed constants (test-4 header)
_A = 6371220.0
_RD = 287.0
_G = 9.80616
_OMEGA_4 = 7.29212e-5
_P0 = 100000.0
_ETA_TROPO = 0.2
_U0 = 35.0
_T0 = 288.0
_ETA0 = 0.252
_RADIUS = 10.0
_PERT_AMPL = 1.0
_PERT_LON = math.radians(20.0)
_PERT_LAT = math.radians(40.0)
_DELTA_T = 480000.0
_GAMMA_4 = 0.005
_Q0_4 = 0.021
_LAT_HW = 2.0 * math.pi / 9.0
_P_HW = 34000.0


def _t_mean(eta):
    exponent = _RD * _GAMMA_4 / _G
    base = _T0 * eta ** exponent
    return torch.where(eta >= _ETA_TROPO, base,
                       base + _DELTA_T * torch.clamp(
                           _ETA_TROPO - eta, min=0.0) ** 5)


def _t_deviation(lat, eta):
    factor = eta * math.pi * _U0 / _RD
    phi_v = (eta - _ETA0) * 0.5 * math.pi
    return factor * 1.5 * torch.sin(phi_v) * torch.cos(phi_v) ** 0.5 * (
        (-2.0 * torch.sin(lat) ** 6 * (torch.cos(lat) ** 2 + 1.0 / 3.0)
         + 10.0 / 63.0) * _U0 * torch.cos(phi_v) ** 1.5
        + (8.0 / 5.0 * torch.cos(lat) ** 3
           * (torch.sin(lat) ** 2 + 2.0 / 3.0)
           - math.pi / 4.0) * _A * _OMEGA_4 * 0.5)


def _surface_geopotential_bw(lat):
    cos_tmp = _U0 * math.cos((1.0 - _ETA0) * math.pi * 0.5) ** 1.5
    return ((-2.0 * torch.sin(lat) ** 6 * (torch.cos(lat) ** 2 + 1.0 / 3.0)
             + 10.0 / 63.0) * cos_tmp
            + (8.0 / 5.0 * torch.cos(lat) ** 3
               * (torch.sin(lat) ** 2 + 2.0 / 3.0)
               - math.pi / 4.0) * _A * _OMEGA_4) * cos_tmp


def baroclinic_wave_ics(p, lon, lat, perturb=True, moist=False):
    """Jablonowski-Williamson baroclinic wave on (nz, ncol) pressure
    (:78)."""
    ps = torch.full_like(lon, _P0)
    eta = p / _P0

    phi_v = (eta - _ETA0) * 0.5 * math.pi
    u = torch.cos(phi_v) ** 1.5 * 4.0 * _U0 * (
        torch.sin(lat) ** 2 * torch.cos(lat) ** 2)[None, :]
    if perturb:
        r = torch.arccos(
            math.sin(_PERT_LAT) * torch.sin(lat)
            + math.cos(_PERT_LAT) * torch.cos(lat)
            * torch.cos(lon - _PERT_LON))
        u = u + (_PERT_AMPL * torch.exp(-(r * _RADIUS) ** 2))[None, :]
    v = torch.zeros_like(u)

    t = _t_mean(eta) + _t_deviation(lat[None, :], eta)
    phis = _surface_geopotential_bw(lat)

    if moist:
        q = _Q0_4 * torch.exp(-(lat[None, :] / _LAT_HW) ** 4) * torch.exp(
            -((eta - 1.0) * _P0 / _P_HW) ** 2)
        t = t / (1.0 + 0.608 * q)
    else:
        q = torch.zeros_like(t)
    return u, v, t, q, ps, phis


# Tropical cyclone constants (test-5 header)
_OMEGA_5 = 7.292115e-5
_RP = 282000.0
_DP = 1115.0
_ZP = 7000.0
_Q0_5 = 0.021
_GAMMA_5 = 0.007
_TS0 = 302.15
_P00 = 101500.0
_CEN_LAT = math.radians(10.0)
_CEN_LON = math.radians(180.0)
_ZQ1 = 3000.0
_ZQ2 = 8000.0
_EXPPR = 1.5
_EXPPZ = 2.0
_ZTROP = 15000.0
_QTROP = 1e-11
_RFPI = 1000000.0
_CONST_TV = 0.608
_EPS_WIND = 1e-25
_EXPONENT_5 = _RD * _GAMMA_5 / _G
_T0_5 = _TS0 * (1.0 + _CONST_TV * _Q0_5)
_TTROP = _T0_5 - _GAMMA_5 * _ZTROP


def _fpi_f(p, gr, z):
    return p - (_P00 - _DP * torch.exp(-(gr / _RP) ** _EXPPR)
                * torch.exp(-(z / _ZP) ** _EXPPZ)) \
        * ((_T0_5 - _GAMMA_5 * z) / _T0_5) ** (_G / (_RD * _GAMMA_5))


def _fpi_dfdz(gr, z):
    expo = _G / (_RD * _GAMMA_5)
    decay = torch.exp(-(gr / _RP) ** _EXPPR) * torch.exp(-(z / _ZP) ** _EXPPZ)
    ratio = (_T0_5 - _GAMMA_5 * z) / _T0_5
    return (-_EXPPZ * z * _DP * decay / (_ZP * _ZP) * ratio ** expo
            + _G / (_RD * _T0_5)
            * (_P00 - _DP * decay) * ratio ** (expo - 1.0))


def tropical_cyclone_ics(p, lon, lat):
    """Reed-Jablonowski analytic tropical cyclone on (nz, ncol) pressure
    (:147)."""
    f = 2.0 * _OMEGA_5 * math.sin(_CEN_LAT)
    gr = _A * torch.arccos(
        math.sin(_CEN_LAT) * torch.sin(lat)
        + math.cos(_CEN_LAT) * torch.cos(lat) * torch.cos(lon - _CEN_LON))

    ps = _P00 - _DP * torch.exp(-(gr / _RP) ** _EXPPR)

    height = (_T0_5 / _GAMMA_5) * (1.0 - (p / ps[None, :]) ** _EXPONENT_5)

    # Newton refinement of the height near the vortex centre, a fixed 20
    # iterations with per-point masking
    gr2 = gr[None, :]
    near = gr2 < _RFPI
    for _ in range(20):
        z_new = height - _fpi_f(p, gr2, height) / _fpi_dfdz(gr2, height)
        height = torch.where(near, z_new, height)

    d1 = math.sin(_CEN_LAT) * torch.cos(lat) - \
        math.cos(_CEN_LAT) * torch.sin(lat) * torch.cos(lon - _CEN_LON)
    d2 = math.cos(_CEN_LAT) * torch.sin(lon - _CEN_LON)
    d = torch.clamp(torch.sqrt(d1 ** 2 + d2 ** 2), min=_EPS_WIND)
    ufac = (d1 / d)[None, :]
    vfac = (d2 / d)[None, :]

    t_minus = _T0_5 - _GAMMA_5 * height
    exp_gr = torch.exp((gr2 / _RP) ** _EXPPR)
    exp_z = torch.exp((height / _ZP) ** _EXPPZ)
    denom = (_EXPPZ * height * _RD * t_minus / (_G * _ZP ** _EXPPZ)
             + (1.0 - _P00 / _DP * exp_gr * exp_z))
    tangential = (-f * gr2 / 2.0
                  + torch.sqrt(torch.clamp(
                      (f * gr2 / 2.0) ** 2
                      - _EXPPR * (gr2 / _RP) ** _EXPPR * _RD * t_minus
                      / denom, min=0.0)))
    in_troposphere = height <= _ZTROP
    u = torch.where(in_troposphere, ufac * tangential, 0.0)
    v = torch.where(in_troposphere, vfac * tangential, 0.0)

    q = torch.where(in_troposphere,
                    _Q0_5 * torch.exp(-height / _ZQ1)
                    * torch.exp(-(height / _ZQ2) ** _EXPPZ),
                    _QTROP)
    t = torch.where(
        in_troposphere,
        t_minus / (1.0 + _CONST_TV * q)
        / (1.0 + _EXPPZ * _RD * t_minus * height
           / (_G * _ZP ** _EXPPZ
              * (1.0 - _P00 / _DP * exp_gr * exp_z))),
        _TTROP)

    phis = torch.zeros_like(ps)
    return u, v, t, q, ps, phis


class DcmipInitialConditions(DiagnosticComponent):
    """Analytic DCMIP baroclinic-wave / tropical-cyclone initial states
    (:206), on ``device`` (the CUDA card unless the caller asks for
    another)."""

    input_properties = {
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
        'longitude': {'dims': ['*'], 'units': 'degrees_east'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'atmosphere_hybrid_sigma_pressure_a_coordinate_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'dimensionless',
            'alias': 'ak'},
        'atmosphere_hybrid_sigma_pressure_b_coordinate_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'dimensionless',
            'alias': 'bk'},
    }

    diagnostic_properties = {
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'surface_geopotential': {'dims': ['*'], 'units': 'm^2 s^-2'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'specific_humidity': {'dims': ['mid_levels', '*'], 'units': 'g/g'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'Pa'},
    }

    def __init__(self, condition_type='baroclinic_wave',
                 add_perturbation=True, moist=False, device='cuda',
                 **kwargs):
        if condition_type not in ('baroclinic_wave', 'tropical_cyclone'):
            raise ValueError(
                "condition_type must be 'baroclinic_wave' or "
                "'tropical_cyclone'")
        if condition_type == 'tropical_cyclone' and not moist:
            raise ValueError(
                'moist must be True for the tropical cyclone test')
        self.device = resolve_device(device)
        self._condition_type = condition_type
        self._add_perturbation = add_perturbation
        self._moist = moist
        super().__init__(**kwargs)

    def array_call(self, state):
        def a(name):
            return as_tensor(state[name], self.device)

        toa_pressure = get_constant('top_of_model_pressure', 'Pa')
        rd = get_constant('gas_constant_of_dry_air', 'J kg^-1 K^-1')
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J kg^-1 K^-1')

        lon = torch.deg2rad(a('longitude'))
        lat = torch.deg2rad(a('latitude'))
        p = a('air_pressure')
        if self._condition_type == 'baroclinic_wave':
            u, v, t, q, ps, phis = baroclinic_wave_ics(
                p, lon, lat, self._add_perturbation, self._moist)
        else:
            u, v, t, q, ps, phis = tropical_cyclone_ics(p, lon, lat)

        p_interface = a('ak') + a('bk') * (ps[None, :] - toa_pressure)
        delta_p = p_interface[1:] - p_interface[:-1]
        rk = rd / cpd
        p_mid = ((p_interface[1:] ** (rk + 1)
                  - p_interface[:-1] ** (rk + 1))
                 / ((rk + 1) * delta_p)) ** (1.0 / rk)
        return {
            'eastward_wind': u,
            'northward_wind': v,
            'air_temperature': t,
            'surface_geopotential': phis,
            'specific_humidity': q,
            'surface_air_pressure': ps,
            'air_pressure': p_mid,
            'air_pressure_on_interface_levels': p_interface,
        }
