"""The moist GCM of the plain reference, one device.

Spectral dynamics (or FV moisture), RRTMG LW+SW clear sky with analytic
transmittance on a lagged cadence, simple-physics surface fluxes and
boundary layer, Emanuel convection, a slab ocean and the global water
fixer, in plain PyTorch: the gas optics through the plain gather-sum and
the LW flux sweep through its plain loops.  A carry is (prev, now, grids,
aux, k), the layout of the program's ``build_moist_gcm``, so the
reference steps from the program's state and its outputs compare field
by field.  The carry of a model built under a mesh is gathered first;
this model has none.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import data
from .dynamics import SpectralDycore
from .grid import (bolton_q_sat, get_interface_values,
                   hybrid_sigma_pressure_coefficients)
from .lw import rrtmg_lw_fluxes
from .physics import emanuel_convect, simple_physics_step
from .sw import rrtmg_sw_fluxes, solar_variability

G = 9.80665
CPD = 1004.64
LV = 2.5e6
RD = 287.0
RV = 461.5
AVOGADRO = 6.022140857e23
SOLAR_CONSTANT = 1367.0
ALBEDO = 0.27
CO2_PPM = 330.0

EMANUEL_PARAMS = dict(
    minorig=0, elcrit=0.0011, tlcrit=-55.0, entp=1.5, sigd=0.05,
    sigs=0.12, omtrain=50.0, omtsnow=5.5, coeffr=1.0, coeffs=0.8,
    cu=0.7, beta=10.0, dtmax=0.9, alpha=0.1, damp=0.1, delt0=300.0,
    g=G, cpd=CPD, cpv=1846.0, rd=RD, rv=RV, lv0=LV,
    rowl=1000.0, cl=2500.0)


def interp1d(x, xp, fp):
    """Linear interpolation for ascending xp, clamped to fp[0] below
    xp[0] and to fp[-1] above xp[-1]."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def radiation_inputs(T, q, p_mid, p_half, Ts, t_seconds, coslat, lon,
                     o3_logp, o3_vals):
    """The RRTMG inputs of (nz, ncol) bottom-up columns with pressures in
    Pa, as the GCM hands them over: (play, plev, T, tlev, Ts, h2ovmr,
    o3vmr, co2, o2, mu0, day, emis)."""
    play = p_mid / 100.0
    plev = p_half / 100.0
    h2ovmr = q * (28.964 / 18.02)
    o3vmr = interp1d(torch.log(p_mid), o3_logp, o3_vals)
    co2 = torch.full_like(T, CO2_PPM * 1e-6)
    o2 = torch.full_like(T, 0.21)
    tlev = get_interface_values(T, Ts, p_mid, p_half)
    hour_angle = 2.0 * math.pi * (t_seconds / 86400.0) + lon
    mu0 = coslat * torch.cos(hour_angle)
    day = mu0 > 0.0
    mu0 = torch.clamp(mu0, min=1e-6)
    emis = torch.ones((16,) + tuple(Ts.shape), dtype=T.dtype,
                      device=T.device)
    return (play, plev, T, tlev, Ts, h2ovmr, o3vmr, co2, o2, mu0, day,
            emis)


def lw_call(play, plev, T, tlev, Ts, h2o, o3, co2, o2, emis):
    """The clear-sky LW call of the GCM: rrtmg_lw_fluxes' outputs."""
    nz, nc = play.shape
    dtype, dev = play.dtype, play.device
    zero = torch.zeros_like(play)
    z16 = torch.zeros((nz, nc, 16), dtype=dtype, device=dev)
    return rrtmg_lw_fluxes(
        play, plev, T, tlev, Ts, h2o, o3, co2, zero, zero, o2, zero,
        zero, zero, zero, emis, zero, z16, zero, zero,
        torch.full_like(play, 25.0), torch.full_like(play, 10.0), z16,
        G, AVOGADRO, CPD, use_tables=False)


def sw_call(play, plev, T, h2o, o3, co2, o2, mu0, sw_scale, solar_config):
    """The clear-sky SW call of the GCM: rrtmg_sw_fluxes' outputs."""
    nz, nc = play.shape
    dtype, dev = play.dtype, play.device
    zero = torch.zeros_like(play)
    alb = torch.full((nc,), ALBEDO, dtype=dtype, device=dev)
    nocloud = (torch.zeros((nz, nc, 14), dtype=dtype, device=dev),) * 4
    noaer = (torch.zeros((nz, nc, 14), dtype=dtype, device=dev),) * 3
    return rrtmg_sw_fluxes(
        play, plev, T, h2o, o3, co2, zero, zero, o2, alb, alb, alb, alb,
        mu0, zero, nocloud, noaer, sw_scale, -1, 0.0, -1, solar_config,
        G, AVOGADRO, CPD, icld=0, use_tables=False)


class MoistGCM(nn.Module):
    """One-device moist GCM: ``init(seed)`` gives the initial carry and
    ``step(carry)`` one model step, (carry, diagnostics)."""

    def __init__(self, nlon, nlat, nz, timestep, number_of_damped_levels=5,
                 ocean_depth=5.0, dtype=torch.float32, rad_every=6,
                 rad_col_chunk=8192, moisture_advection='spectral',
                 device='cuda'):
        super().__init__()
        ak, bk = hybrid_sigma_pressure_coefficients(nz + 1, 1e5, 20.0)
        self.dycore = SpectralDycore(
            nlon, nlat, nz, ak, bk, timestep=timestep,
            number_of_damped_levels=number_of_damped_levels, dtype=dtype,
            device=device, moisture_advection=moisture_advection)
        self.nz, self.nlat, self.nlon = nz, nlat, nlon
        self.dt = timestep
        self.dtype = dtype
        self.ocean_depth = ocean_depth
        self.rad_every = rad_every
        self.conserve_water = moisture_advection != 'fv'

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dtype, device=device))

        mu = self.dycore.sht.mu
        ncol = nlat * nlon
        lat = np.arcsin(mu)
        lon = 2.0 * np.pi * np.arange(nlon) / nlon
        buf('rad_coslat', (np.cos(lat)[:, None]
                           * np.ones((1, nlon))).reshape(-1))
        buf('rad_lon', np.broadcast_to(lon[None, :], (nlat, nlon))
            .reshape(-1))
        self.solar_config = solar_variability(-1, 0.0)
        self.sw_scale = SOLAR_CONSTANT / 1368.22
        buf('o3_logp', np.log(1e5 * np.linspace(0.998, 0.001, 30)[::-1]))
        buf('o3_vals', data.load_numpy(data.OZONE)[::-1])
        self.rad_chunks = (max(1, ncol // rad_col_chunk)
                           if ncol % rad_col_chunk == 0 else 1)
        buf('wlat', np.asarray(self.dycore.sht.weights)[None, :, None])

    def radiation(self, T, q, p_mid, p_half, Ts, t_seconds):
        """Heating rate (K/s) and surface/TOA fluxes, chunk by chunk."""
        inputs = radiation_inputs(T, q, p_mid, p_half, Ts, t_seconds,
                                  self.rad_coslat, self.rad_lon,
                                  self.o3_logp, self.o3_vals)
        outs = []
        for cols in torch.chunk(torch.arange(T.shape[1]), self.rad_chunks):
            c = slice(int(cols[0]), int(cols[-1]) + 1)
            outs.append(self._radiation_chunk(*(
                x[c] if x.dim() == 1 else x[:, c] for x in inputs)))
        hr, sfc, olr, asr = (torch.cat([o[i] for o in outs], dim=-1)
                             for i in range(4))
        return {'hr_rad': hr, 'sfc_rad': sfc, 'olr': olr, 'asr': asr}

    def _radiation_chunk(self, play, plev, T, tlev, Ts, h2o, o3, co2, o2,
                         mu0, day, emis):
        lw = lw_call(play, plev, T, tlev, Ts, h2o, o3, co2, o2, emis)
        lw_up, lw_dn, lw_hr = lw[0], lw[1], lw[2]
        sw_up, sw_dn, _, _, sw_hr, _ = sw_call(
            play, plev, T, h2o, o3, co2, o2, mu0, self.sw_scale,
            self.solar_config)
        sw_up = torch.where(day[None, :], sw_up, 0.0)
        sw_dn = torch.where(day[None, :], sw_dn, 0.0)
        sw_hr = torch.where(day[None, :], sw_hr, 0.0)
        hr = (lw_hr + sw_hr) / 86400.0
        return (hr, sw_dn[0] - sw_up[0] + lw_dn[0] - lw_up[0],
                lw_up[-1], sw_dn[-1] - sw_up[-1])

    def _to_cols(self, x):
        """(nz, nlat, nlon) top-down -> (nz, ncol) bottom-up."""
        return torch.flip(x.reshape(x.shape[0], -1), [0])

    def _to_grid3(self, x):
        return torch.flip(x, [0]).reshape(self.nz, self.nlat, self.nlon)

    def physics(self, grids, aux, step_idx):
        """(tendencies, aux, diagnostics) of one step."""
        nlat, nlon, dt = self.nlat, self.nlon, self.dt
        u = self._to_cols(grids['u'])
        v = self._to_cols(grids['v'])
        T = self._to_cols(grids['T'])
        q = torch.clamp(self._to_cols(grids['q']), min=0.0)
        ps = grids['ps'].reshape(-1)
        p_half = self._to_cols(grids['p_half'])
        p_mid = 0.5 * (p_half[1:] + p_half[:-1])
        Ts = aux['Ts'].reshape(-1)
        cbmf = aux['cbmf'].reshape(-1)

        if step_idx % self.rad_every == 0:
            t_model = torch.tensor(step_idx, dtype=T.dtype,
                                   device=T.device) * dt
            rad = self.radiation(T, q, p_mid, p_half, Ts, t_model)
        else:
            rad = {'hr_rad': self._to_cols(aux['hr_rad']),
                   'sfc_rad': aux['sfc_rad'].reshape(-1),
                   'olr': aux['olr'].reshape(-1),
                   'asr': aux['asr'].reshape(-1)}

        qsurf = torch.zeros_like(ps)
        T2, q2, u2, v2, precip_ls, shf, lhf = simple_physics_step(
            T, q, u, v, p_mid, p_half, ps, Ts, qsurf, dt,
            G, CPD, RD, RV, LV, 1000.0,
            85000.0, 20000.0, 0.0011, 0.0007, 0.000065, 0.002,
            True, True, True, False)
        lhf = torch.clamp(lhf, min=0.0)
        qs = bolton_q_sat(T, p_mid, RD, RV)
        conv = emanuel_convect(
            T.T, q.T, qs.T, u.T, v.T, (p_mid / 100.0).T,
            (p_half / 100.0).T, cbmf, dt, self.nz - 3, EMANUEL_PARAMS)

        du = (u2 - u) / dt + conv['fu'].T
        dv = (v2 - v) / dt + conv['fv'].T
        dT = (T2 - T) / dt + rad['hr_rad'] + conv['ft'].T
        dq = (q2 - q) / dt + conv['fq'].T

        net_sfc = rad['sfc_rad'] - shf - lhf
        heat_capacity = 1.029e3 * 4.1813e3 * self.ocean_depth
        Ts_new = Ts + dt * net_sfc / heat_capacity

        aux_new = {
            'Ts': Ts_new.reshape(nlat, nlon),
            'cbmf': conv['cbmf'].reshape(nlat, nlon),
            'hr_rad': self._to_grid3(rad['hr_rad']),
            'sfc_rad': rad['sfc_rad'].reshape(nlat, nlon),
            'olr': rad['olr'].reshape(nlat, nlon),
            'asr': rad['asr'].reshape(nlat, nlon),
        }
        diag = {
            'olr': rad['olr'].reshape(nlat, nlon),
            'asr': rad['asr'].reshape(nlat, nlon),
            'conv_precip': conv['precip'].reshape(nlat, nlon),
            'ls_precip': precip_ls.reshape(nlat, nlon),
            'shf': shf.reshape(nlat, nlon),
            'lhf': lhf.reshape(nlat, nlon),
        }
        phys = {'du': self._to_grid3(du), 'dv': self._to_grid3(dv),
                'dT': self._to_grid3(dT), 'dq': self._to_grid3(dq)}
        return phys, aux_new, diag

    def init(self, seed):
        """Initial carry (prev, now, grids, aux, 0) from a numpy seed: a
        zonally symmetric moist atmosphere at rest with 0.1 K of seeded
        temperature noise."""
        nz, nlat, nlon = self.nz, self.nlat, self.nlon
        dycore = self.dycore
        rng = np.random.RandomState(seed)
        shape = (nz, nlat, nlon)
        mu = dycore.sht.mu
        Ts2d = 300.0 - 40.0 * mu[:, None] ** 2 * np.ones((1, nlon))
        sigma = np.linspace(0.02, 0.98, nz)[:, None, None]
        T = (Ts2d[None] - 60.0) + 60.0 * sigma ** 0.7
        T = np.maximum(T, 195.0) + 0.1 * rng.randn(*shape)
        q = 0.8 * 0.622 * 611.2 / 1e5 * np.exp(
            17.67 * (T - 273.15) / (T - 29.65)) * sigma ** 1.5
        q = np.clip(q, 1e-7, 0.025)
        lnps = np.full((nlat, nlon), np.log(1e5))
        dev = self.wlat.device

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   dtype=self.dtype, device=dev)

        zeros = t(np.zeros(shape))
        spec = dycore.spectral_state_from_grid(zeros, zeros, t(T), t(q),
                                               t(lnps))
        prev, now = dycore.initial_step(spec)
        grids = dycore.grids_of(prev)
        flat = np.zeros((nlat, nlon))
        aux = {'Ts': t(Ts2d), 'cbmf': t(flat), 'hr_rad': t(np.zeros(shape)),
               'sfc_rad': t(flat), 'olr': t(flat), 'asr': t(flat)}
        return prev, now, grids, aux, 0

    def _fix_water(self, new, prev, phys):
        """Global multiplicative moisture mass fixer on spectral q."""
        sht = self.dycore.sht
        q_prev = self.dycore._q_grid(prev)
        ps_prev = torch.exp(sht.synthesize(prev['lnps']))
        ph_prev, _, _, _ = self.dycore._vertical_structures(ps_prev)
        dp_prev = ph_prev[1:] - ph_prev[:-1]
        q_new = self.dycore._q_grid(new)
        ps_new = torch.exp(sht.synthesize(new['lnps']))
        ph_new, _, _, _ = self.dycore._vertical_structures(ps_new)
        q_pos = torch.clamp(q_new, min=0.0)
        src = torch.sum(self.wlat * phys['dq'] * dp_prev)
        tw_prev = torch.sum(self.wlat * q_prev * dp_prev)
        tw_new = torch.sum(self.wlat * q_pos * (ph_new[1:] - ph_new[:-1]))
        target = tw_prev + 2.0 * self.dt * src
        scale = torch.where(tw_new > 0.0,
                            torch.clamp(target, min=0.0) / tw_new, 1.0)
        return dict(new, q=sht.analyze(q_pos * scale))

    def step(self, carry):
        """One model step: carry -> (carry, diagnostics)."""
        prev, now, prev_grids, aux, k = carry
        phys, aux_new, diag = self.physics(prev_grids, aux, k)
        filtered, new, now_grids = self.dycore.step(prev, now, phys=phys)
        if self.conserve_water:
            new = self._fix_water(new, prev, phys)
        return (filtered, new, now_grids, aux_new, k + 1), diag
