"""Reed-Jablonowski (2012) simple physics on tensors
(climt_tpu/components/simple_physics.py).

Large-scale condensation, bulk surface fluxes with the Smith-Vogl drag
law, and the partially implicit boundary-layer diffusion whose
tridiagonal solve is an upward elimination plus a downward
back-substitution (Python loops over levels here, ``lax.scan`` there).
Level index 0 is the lowest layer; arrays are (nz, ncol).
``SimplePhysics`` is the climt Stepper over it, computing on its
``device``.
"""

from __future__ import annotations

import math

import torch

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import resolve_device


def _large_scale_condensation(T, q, p_mid, dp, dt, consts):
    """Saturation adjustment with latent-heat feedback (:33)."""
    eps, e0, T0 = consts['eps'], 610.78, 273.16
    lv, cp, rd, rv = consts['lv'], consts['cp'], consts['rd'], consts['rv']
    qsat = eps * e0 / p_mid * torch.exp(-lv / rv * (1.0 / T - 1.0 / T0))
    tmp = torch.where(
        q > qsat,
        (1.0 / dt) * (q - qsat)
        / (1.0 + (lv / cp) * (eps * lv * qsat / (rd * T ** 2))),
        0.0)
    new_T = T + (lv / cp) * tmp * dt
    new_q = q - tmp * dt
    precipitation = torch.sum(
        tmp * dp / (consts['g'] * consts['rhow']), dim=0)
    return new_T, new_q, precipitation


def _surface_fluxes(T, q, u, v, p_mid, p_int, ps, Ts, qsurf, za, dt,
                    consts, use_qsurf_ext):
    """Implicit surface drag, explicit sensible/latent heating of the
    lowest layer (:49)."""
    c_heat = consts['C']
    wind = torch.sqrt(u[0] ** 2 + v[0] ** 2)
    cd = torch.where(wind < 20.0, consts['Cd0'] + consts['Cd1'] * wind,
                     consts['Cm'])
    drag = 1.0 + cd * wind * dt / za
    u = torch.cat([(u[0] / drag)[None], u[1:]], dim=0)
    v = torch.cat([(v[0] / drag)[None], v[1:]], dim=0)

    dp_low = p_int[0] - p_int[1]
    rho = p_mid[0] / (consts['rd'] * T[0])
    t_flux = c_heat * wind * (Ts - T[0])
    sensible = rho * consts['cp'] * t_flux
    T = torch.cat([(T[0] + t_flux * (rho * consts['g']) / dp_low * dt)[None],
                   T[1:]], dim=0)

    es_warm = (1.0007 + 3.46e-8 * ps) * 611.21 * torch.exp(
        17.966 * (Ts - 273.) / (247.15 + (Ts - 273.)))
    es_cold = (1.0003 + 4.18e-8 * ps) * 611.15 * torch.exp(
        22.452 * (Ts - 273.) / (272.5 + (Ts - 273.)))
    es = torch.where(Ts > 271.0, es_warm, es_cold)
    qsats = consts['eps'] * es / (ps - 0.378 * es)
    if use_qsurf_ext:
        qsats = qsurf

    rho = p_mid[0] / (consts['rd'] * T[0])
    q_flux = c_heat * wind * (qsats - q[0])
    latent = consts['lv'] * rho * q_flux
    q = torch.cat([(q[0] + q_flux * (rho * consts['g']) / dp_low * dt)[None],
                   q[1:]], dim=0)
    return T, q, u, v, sensible, latent, wind, cd


def _pbl_diffusion(T, q, u, v, p_mid, p_int, dp, za, wind, cd, dt, consts):
    """Implicit vertical diffusion (:90): upward elimination, downward
    back-substitution, one loop each over the levels."""
    nz = T.shape[0]
    kappa = consts['rd'] / consts['cp']
    p0 = 1e5
    ke_surf = consts['C'] * wind * za
    km_surf = cd * wind * za

    p_i = p_int[1:-1]
    taper = torch.where(
        p_i >= consts['pbltop'], 1.0,
        torch.exp(-((consts['pbltop'] - p_i) / consts['pblconst']) ** 2))
    km = km_surf[None, :] * taper
    ke = ke_surf[None, :] * taper
    rho_i = p_i / (consts['rd'] * 0.5 * (T[1:] + T[:-1]))
    g2dt = dt * consts['g'] ** 2
    dpm = p_mid[:-1] - p_mid[1:]

    zero_row = torch.zeros_like(T[:1])
    ca_m = torch.cat([zero_row, g2dt * km * rho_i ** 2 / (dpm * dp[1:])])
    cc_m = torch.cat([g2dt * km * rho_i ** 2 / (dpm * dp[:-1]), zero_row])
    ca_e = torch.cat([zero_row, g2dt * ke * rho_i ** 2 / (dpm * dp[1:])])
    cc_e = torch.cat([g2dt * ke * rho_i ** 2 / (dpm * dp[:-1]), zero_row])

    theta = T * (p0 / p_mid) ** kappa

    zero = torch.zeros_like(wind)
    e_m_b = e_e_b = fu_b = fv_b = ft_b = fq_b = zero
    e_m, e_e, fu, fv, ft, fq = [], [], [], [], [], []
    for j in range(nz):
        denom_m = 1.0 + ca_m[j] + cc_m[j] - ca_m[j] * e_m_b
        denom_e = 1.0 + ca_e[j] + cc_e[j] - ca_e[j] * e_e_b
        e_m_b = cc_m[j] / denom_m
        e_e_b = cc_e[j] / denom_e
        fu_b = (u[j] + ca_m[j] * fu_b) / denom_m
        fv_b = (v[j] + ca_m[j] * fv_b) / denom_m
        ft_b = (theta[j] + ca_e[j] * ft_b) / denom_e
        fq_b = (q[j] + ca_e[j] * fq_b) / denom_e
        for lst, val in ((e_m, e_m_b), (e_e, e_e_b), (fu, fu_b),
                         (fv, fv_b), (ft, ft_b), (fq, fq_b)):
            lst.append(val)

    u_a = v_a = th_a = q_a = zero
    u_new, v_new, th_new, q_new = [None] * nz, [None] * nz, [None] * nz, \
        [None] * nz
    for j in range(nz - 1, -1, -1):
        u_a = e_m[j] * u_a + fu[j]
        v_a = e_m[j] * v_a + fv[j]
        th_a = e_e[j] * th_a + ft[j]
        q_a = e_e[j] * q_a + fq[j]
        u_new[j], v_new[j], th_new[j], q_new[j] = u_a, v_a, th_a, q_a

    T_new = torch.stack(th_new) * (p_mid / p0) ** kappa
    return T_new, torch.stack(q_new), torch.stack(u_new), torch.stack(v_new)


def simple_physics_step(T, q, u, v, p_mid, p_int, ps, Ts, qsurf, dt,
                        g, cp, rd, rv, lv, rhow, pbltop, pblconst,
                        c_heat, cd0, cd1, cm,
                        do_lsc, do_pbl, do_surf_flux, use_qsurf_ext):
    """One time-split simple-physics step (:167).  Returns
    (T, q, u, v, precipitation, sensible, latent)."""
    consts = dict(g=g, cp=cp, rd=rd, rv=rv, lv=lv, rhow=rhow,
                  eps=rd / rv, C=c_heat, Cd0=cd0, Cd1=cd1, Cm=cm,
                  pbltop=pbltop, pblconst=pblconst)
    zvir = rv / rd - 1.0
    dp = p_int[:-1] - p_int[1:]
    za = (rd / g) * T[0] * (1.0 + zvir * q[0]) * 0.5 * (
        torch.log(ps) - torch.log(p_int[1]))

    precipitation = torch.zeros_like(ps)
    if do_lsc:
        T, q, precipitation = _large_scale_condensation(
            T, q, p_mid, dp, dt, consts)

    sensible = torch.zeros_like(ps)
    latent = torch.zeros_like(ps)
    wind = torch.sqrt(u[0] ** 2 + v[0] ** 2)
    cd = torch.where(wind < 20.0, cd0 + cd1 * wind, cm)
    if do_surf_flux:
        T, q, u, v, sensible, latent, wind, cd = _surface_fluxes(
            T, q, u, v, p_mid, p_int, ps, Ts, qsurf, za, dt, consts,
            use_qsurf_ext)
    if do_pbl:
        T, q, u, v = _pbl_diffusion(
            T, q, u, v, p_mid, p_int, dp, za, wind, cd, dt, consts)
    return T, q, u, v, precipitation, sensible, latent



class SimplePhysics(Stepper):
    """Reed & Jablonowski (2012) surface fluxes, boundary layer and
    large-scale condensation (:202), on ``device`` (the CUDA card unless
    the caller asks for another)."""

    input_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'Pa'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'specific_humidity': {'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'surface_specific_humidity': {'dims': ['*'], 'units': 'kg/kg'},
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
    }

    diagnostic_properties = {
        'stratiform_precipitation_rate': {'dims': ['*'], 'units': 'm s^-1'},
        'surface_upward_latent_heat_flux': {'dims': ['*'],
                                            'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {'dims': ['*'],
                                              'units': 'W m^-2'},
    }

    output_properties = {
        'air_temperature': {'units': 'degK'},
        'specific_humidity': {'units': 'kg/kg'},
        'northward_wind': {'units': 'm s^-1'},
        'eastward_wind': {'units': 'm s^-1'},
    }

    def __init__(self, simulate_cyclone=False, large_scale_condensation=True,
                 boundary_layer=True, surface_fluxes=True,
                 use_external_surface_temperature=True,
                 use_external_surface_specific_humidity=False,
                 top_of_boundary_layer=85000.0,
                 boundary_layer_influence_height=20000.0,
                 drag_coefficient_heat_fluxes=0.0011,
                 base_momentum_drag_coefficient=0.0007,
                 wind_dependent_momentum_drag_coefficient=0.000065,
                 maximum_momentum_drag_coefficient=0.002,
                 device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        self._cyclone = simulate_cyclone
        self._lsc = large_scale_condensation
        self._pbl = boundary_layer
        self._surface_flux = surface_fluxes
        self._use_ext_ts = use_external_surface_temperature
        self._use_ext_qsurf = use_external_surface_specific_humidity
        self._Ct = drag_coefficient_heat_fluxes
        self._pbl_top = top_of_boundary_layer
        self._delta_pbl = boundary_layer_influence_height
        self._Cd0 = base_momentum_drag_coefficient
        self._Cd1 = wind_dependent_momentum_drag_coefficient
        self._Cm = maximum_momentum_drag_coefficient
        super().__init__(**kwargs)

    def _surface_temperature(self, raw_state, rd, a, omega):
        """The external surface temperature, the latitude-dependent SST
        of the moist baroclinic-wave test, or the constant 302.15 K of the
        tropical-cyclone test (:259)."""
        if self._use_ext_ts:
            return as_tensor(raw_state['surface_temperature'], self.device)
        lat = torch.deg2rad(as_tensor(raw_state['latitude'], self.device))
        if not self._cyclone:
            return torch.full_like(lat, 302.15)
        zvir = (461.5 / rd) - 1.0
        u0, T00 = 35.0, 288.0
        latw = 2.0 * math.pi / 9.0
        etav = (1 - 0.252) * 0.5 * math.pi
        q0 = 0.021
        return (T00 + math.pi * u0 / rd * 1.5 * math.sin(etav)
                * math.cos(etav) ** 0.5 *
                ((-2. * torch.sin(lat) ** 6
                  * (torch.cos(lat) ** 2 + 1. / 3.) + 10. / 63.)
                 * u0 * math.cos(etav) ** 1.5
                 + (8. / 5. * torch.cos(lat) ** 3
                    * (torch.sin(lat) ** 2 + 2. / 3.)
                    - math.pi / 4.) * a * omega * 0.5)) / (
            1. + zvir * q0 * torch.exp(-(lat / latw) ** 4))

    def array_call(self, raw_state, timestep):
        rd = get_constant('gas_constant_of_dry_air', 'J/kg/degK')
        Ts = self._surface_temperature(
            raw_state, rd, get_constant('planetary_radius', 'm'),
            get_constant('planetary_rotation_rate', 's^-1'))
        T, q, u, v, precipitation, sensible, latent = simple_physics_step(
            *(as_tensor(raw_state[name], self.device) for name in (
                'air_temperature', 'specific_humidity', 'eastward_wind',
                'northward_wind', 'air_pressure',
                'air_pressure_on_interface_levels',
                'surface_air_pressure')),
            Ts, as_tensor(raw_state['surface_specific_humidity'],
                          self.device),
            timestep_seconds(timestep),
            get_constant('gravitational_acceleration', 'm/s^2'),
            get_constant('heat_capacity_of_dry_air_at_constant_pressure',
                         'J/kg/degK'),
            rd, get_constant('gas_constant_of_vapor_phase', 'J/kg/degK'),
            get_constant('latent_heat_of_condensation', 'J/kg'),
            get_constant('density_of_liquid_water', 'kg/m^3'),
            self._pbl_top, self._delta_pbl,
            self._Ct, self._Cd0, self._Cd1, self._Cm,
            self._lsc, self._pbl, self._surface_flux, self._use_ext_qsurf)
        diagnostics = {
            'stratiform_precipitation_rate': precipitation,
            'surface_upward_sensible_heat_flux': sensible,
            'surface_upward_latent_heat_flux': torch.clamp(latent, min=0.0),
        }
        new_state = {
            'eastward_wind': u,
            'northward_wind': v,
            'air_temperature': T,
            'specific_humidity': q,
        }
        return diagnostics, new_state
