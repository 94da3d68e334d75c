"""Fused moist GCM: spectral dynamics + full physics
(climt_tpu/dycore/moist_gcm.py).

The flagship model: the spectral primitive-equation core with RRTMG
radiation (112-g-point SW, 140-g-point LW) on a lagged cadence,
simple-physics surface fluxes and boundary layer, Emanuel convection, a
slab ocean and the global water fixer.  Grid fields are (nz, nlat, nlon)
top-down; column physics sees (nz, ncol) bottom-up.

Where the JAX model is traced into one ``lax.scan``, this one runs
eagerly: the radiation cadence is a Python ``if`` on the step index, and
the radiation column chunks are a Python loop.  ``MoistGCM`` is an
``nn.Module`` whose buffers (the dycore's Legendre tensors and level
matrices, the radiation geometry, the ozone profile) follow ``.to()``.

Under a mesh (``build_moist_gcm(mesh=...)``) each rank runs the model on
its latitude block: the column physics and radiation on its own columns,
the dynamics through the distributed transform, and the water fixer's
global sums all-reduced over the mesh's 'lat' group.

A carry placed by ``parallel.shard_model_state`` (DTensors of the
replicated-spectral layout) is stepped by the same ``step``/``run``: they
build once per (mesh, ``shard_lon``) a rank-local twin of the model on
``parallel.ReplicatedSHT``, run it on the carry's local blocks (the
physics on the rank's latitude x longitude block, the spectral part whole
and identical on every rank), and wrap the results with the same
placements.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .. import data
from ..components.emanuel_convection import emanuel_convect
from ..components.rrtmg.lw_spectral import rrtmg_lw_fluxes
from ..components.rrtmg.sw_spectral import rrtmg_sw_fluxes, solar_variability
from ..components.simple_physics import simple_physics_step
from ..core.grid import hybrid_sigma_pressure_coefficients
from ..core.util import (bolton_q_sat, get_interface_values,
                         resolve_device)
from ..parallel.mesh import carry_layout, unwrap_carry, wrap_carry
from ..utils.profiling import phase
from .spectral_dynamics import SpectralDycore

_G = 9.80665
_CPD = 1004.64
_LV = 2.5e6
_RD = 287.0
_RV = 461.5
_AVOGADRO = 6.022140857e23
# radiation settings of _make_radiation's defaults (moist_gcm.py:56-57)
_SOLAR_CONSTANT = 1367.0
_ALBEDO = 0.27
_CO2_PPM = 330.0

# Emanuel parameters of build_moist_gcm (moist_gcm.py:321-326)
EMANUEL_PARAMS = dict(
    minorig=0, elcrit=0.0011, tlcrit=-55.0, entp=1.5, sigd=0.05,
    sigs=0.12, omtrain=50.0, omtsnow=5.5, coeffr=1.0, coeffs=0.8,
    cu=0.7, beta=10.0, dtmax=0.9, alpha=0.1, damp=0.1, delt0=300.0,
    g=_G, cpd=_CPD, cpv=1846.0, rd=_RD, rv=_RV, lv0=_LV,
    rowl=1000.0, cl=2500.0)


def interp1d(x, xp, fp):
    """``jnp.interp`` for ascending xp: linear inside, clamped to fp[0]
    below xp[0] and to fp[-1] above xp[-1]."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class MoistGCM(nn.Module):
    """The moist GCM of ``build_moist_gcm``; see that function."""

    def __init__(self, nlon, nlat, nz, timestep, number_of_damped_levels,
                 ocean_depth, dtype, rad_every, rad_col_chunk,
                 conserve_water, device='cuda',
                 moisture_advection='spectral', mesh=None,
                 layout='m_sharded', shard_lon=False, fft_impl='fft'):
        super().__init__()
        device = resolve_device(device)
        # the arguments a rank-local twin is built with (``_layout_twin``)
        self._args = dict(
            nlon=nlon, nlat=nlat, nz=nz, timestep=timestep,
            number_of_damped_levels=number_of_damped_levels,
            ocean_depth=ocean_depth, dtype=dtype, rad_every=rad_every,
            rad_col_chunk=rad_col_chunk, conserve_water=conserve_water,
            device=device, moisture_advection=moisture_advection,
            fft_impl=fft_impl)
        self._twins = {}
        ak, bk = hybrid_sigma_pressure_coefficients(nz + 1, 1e5, 20.0)
        self.dycore = SpectralDycore(
            nlon, nlat, nz, ak, bk, timestep=timestep,
            number_of_damped_levels=number_of_damped_levels, dtype=dtype,
            device=device, moisture_advection=moisture_advection, mesh=mesh,
            layout=layout, shard_lon=shard_lon, fft_impl=fft_impl)
        # the latitude rows and longitude columns this model holds: all,
        # or its mesh block
        self.rows, self.cols = self.dycore.sht.rows, self.dycore.sht.cols
        self.nz = nz
        self.nlat = self.dycore.sht.mu[self.rows].shape[0]
        self.nlon = len(range(nlon)[self.cols])
        self.dt = timestep
        self.dtype = dtype
        self.ocean_depth = ocean_depth
        self.rad_every = rad_every
        self.conserve_water = conserve_water
        self.em_params = dict(EMANUEL_PARAMS)

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dtype, device=device))

        # radiation geometry (moist_gcm.py:65-73): equinox diurnal cycle
        # on the rank's rows and columns: the diurnal cycle follows each
        # column's own longitude
        mu = self.dycore.sht.mu[self.rows]
        ncol = self.nlat * self.nlon
        lat = np.arcsin(mu)
        lon = (2.0 * np.pi * np.arange(nlon) / nlon)[self.cols]
        buf('rad_coslat', (np.cos(lat)[:, None]
                           * np.ones((1, self.nlon))).reshape(-1))
        buf('rad_lon', np.broadcast_to(lon[None, :], (self.nlat, self.nlon))
            .reshape(-1))
        self.solar_config = solar_variability(-1, 0.0)
        self.sw_scale = _SOLAR_CONSTANT / 1368.22    # rrsw scon
        # climatological ozone (mole/mole) on 30 reference pressures
        buf('o3_logp', np.log(1e5 * np.linspace(0.998, 0.001, 30)[::-1]))
        buf('o3_vals', data.load_numpy(data.OZONE)[::-1])
        self.rad_chunks = (max(1, ncol // rad_col_chunk)
                           if ncol % rad_col_chunk == 0 else 1)
        # Gaussian-quadrature area weights for the water fixer
        buf('wlat', np.asarray(self.dycore.sht.weights)[self.rows][
            None, :, None])

    # ------------------------------------------------------------------
    def radiation_inputs(self, T, q, p_mid, p_half, Ts, t_seconds):
        """The column inputs of ``_radiation_chunk``, in its argument
        order, for (nz, ncol) bottom-up columns with pressures in Pa."""
        play = p_mid / 100.0
        plev = p_half / 100.0
        h2ovmr = q * (28.964 / 18.02)
        o3vmr = interp1d(torch.log(p_mid), self.o3_logp, self.o3_vals)
        co2 = torch.full_like(T, _CO2_PPM * 1e-6)
        o2 = torch.full_like(T, 0.21)
        tlev = get_interface_values(T, Ts, p_mid, p_half)

        hour_angle = (2.0 * math.pi * (t_seconds / 86400.0) + self.rad_lon)
        mu0 = self.rad_coslat * torch.cos(hour_angle)
        day = mu0 > 0.0
        mu0 = torch.clamp(mu0, min=1e-6)
        emis = torch.ones((16,) + tuple(Ts.shape), dtype=T.dtype,
                          device=T.device)
        return (play, plev, T, tlev, Ts, h2ovmr, o3vmr, co2, o2, mu0, day,
                emis)

    def radiation(self, T, q, p_mid, p_half, Ts, t_seconds):
        """Heating rate (K/s) and surface/TOA fluxes of (nz, ncol)
        bottom-up columns, pressures in Pa (moist_gcm.py:83)."""
        with phase('climt.radiation'):
            inputs = self.radiation_inputs(T, q, p_mid, p_half, Ts, t_seconds)
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
        nz, nc = play.shape
        dtype, dev = play.dtype, play.device
        zero = torch.zeros_like(play)
        lw = rrtmg_lw_fluxes(
            play, plev, T, tlev, Ts, h2o, o3, co2, zero, zero, o2, zero,
            zero, zero, zero, emis, zero,
            torch.zeros((nz, nc, 16), dtype=dtype, device=dev), zero, zero,
            torch.full_like(play, 25.0), torch.full_like(play, 10.0),
            torch.zeros((nz, nc, 16), dtype=dtype, device=dev),
            _G, _AVOGADRO, _CPD, use_tables=False)
        lw_up, lw_dn, lw_hr = lw[0], lw[1], lw[2]

        alb = torch.full((nc,), _ALBEDO, dtype=dtype, device=dev)
        nocloud = (torch.zeros((nz, nc, 14), dtype=dtype, device=dev),) * 4
        noaer = (torch.zeros((nz, nc, 14), dtype=dtype, device=dev),) * 3
        sw_up, sw_dn, _, _, sw_hr, _ = rrtmg_sw_fluxes(
            play, plev, T, h2o, o3, co2, zero, zero, o2, alb, alb, alb, alb,
            mu0, zero, nocloud, noaer, self.sw_scale, -1, 0.0, -1,
            self.solar_config, _G, _AVOGADRO, _CPD, icld=0, use_tables=False)
        sw_up = torch.where(day[None, :], sw_up, 0.0)
        sw_dn = torch.where(day[None, :], sw_dn, 0.0)
        sw_hr = torch.where(day[None, :], sw_hr, 0.0)
        hr = (lw_hr + sw_hr) / 86400.0                 # K/day -> K/s
        return (hr, sw_dn[0] - sw_up[0] + lw_dn[0] - lw_up[0],
                lw_up[-1], sw_dn[-1] - sw_up[-1])

    # ------------------------------------------------------------------
    def _to_cols(self, x):
        """(nz, nlat, nlon) top-down -> (nz, ncol) bottom-up."""
        return torch.flip(x.reshape(x.shape[0], -1), [0])

    def _to_grid3(self, x):
        return torch.flip(x, [0]).reshape(self.nz, self.nlat, self.nlon)

    def physics(self, grids, aux, step_idx):
        """(tendencies, aux, diagnostics) of one step (moist_gcm.py:192)."""
        with phase('climt.physics'):
            nz, nlat, nlon, dt = self.nz, self.nlat, self.nlon, self.dt
            u = self._to_cols(grids['u'])
            v = self._to_cols(grids['v'])
            T = self._to_cols(grids['T'])
            q = torch.clamp(self._to_cols(grids['q']), min=0.0)
            ps = grids['ps'].reshape(-1)
            p_half = self._to_cols(grids['p_half'])
            p_mid = 0.5 * (p_half[1:] + p_half[:-1])
            Ts = aux['Ts'].reshape(-1)
            cbmf = aux['cbmf'].reshape(-1)

            # radiation on a lagged cadence
            if step_idx % self.rad_every == 0:
                t_model = torch.tensor(step_idx, dtype=T.dtype,
                                       device=T.device) * dt
                rad = self.radiation(T, q, p_mid, p_half, Ts, t_model)
            else:
                rad = {'hr_rad': self._to_cols(aux['hr_rad']),
                       'sfc_rad': aux['sfc_rad'].reshape(-1),
                       'olr': aux['olr'].reshape(-1),
                       'asr': aux['asr'].reshape(-1)}
            hr_rad = rad['hr_rad']
            net_sfc_rad = rad['sfc_rad']

            # surface fluxes + boundary layer
            qsurf = torch.zeros_like(ps)
            T2, q2, u2, v2, precip_ls, shf, lhf = simple_physics_step(
                T, q, u, v, p_mid, p_half, ps, Ts, qsurf, dt,
                _G, _CPD, _RD, _RV, _LV, 1000.0,
                85000.0, 20000.0, 0.0011, 0.0007, 0.000065, 0.002,
                True, True, True, False)
            lhf = torch.clamp(lhf, min=0.0)
            du_sp = (u2 - u) / dt
            dv_sp = (v2 - v) / dt
            dT_sp = (T2 - T) / dt
            dq_sp = (q2 - q) / dt

            # Emanuel convection
            qs = bolton_q_sat(T, p_mid, _RD, _RV)
            p_mb, ph_mb = p_mid / 100.0, p_half / 100.0
            with phase('climt.convection'):
                conv = emanuel_convect(
                    T.T, q.T, qs.T, u.T, v.T, p_mb.T, ph_mb.T, cbmf, dt,
                    nz - 3, self.em_params)

            du = du_sp + conv['fu'].T
            dv = dv_sp + conv['fv'].T
            dT = dT_sp + hr_rad + conv['ft'].T
            dq = dq_sp + conv['fq'].T

            # slab ocean
            net_sfc = net_sfc_rad - shf - lhf
            heat_capacity = 1.029e3 * 4.1813e3 * self.ocean_depth
            Ts_new = Ts + dt * net_sfc / heat_capacity

            aux_new = {
                'Ts': Ts_new.reshape(nlat, nlon),
                'cbmf': conv['cbmf'].reshape(nlat, nlon),
                'hr_rad': self._to_grid3(hr_rad),
                'sfc_rad': net_sfc_rad.reshape(nlat, nlon),
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

    # ------------------------------------------------------------------
    def init(self, seed=0):
        """Initial carry (prev, now, grids, aux, 0) from a numpy seed,
        exactly as moist_gcm.py:347-367 builds it.  The global fields are
        drawn and a mesh rank keeps its block, so one seed gives one model
        on any number of ranks."""
        nz = self.nz
        nlat, nlon = self.dycore.sht.nlat, self.dycore.sht.nlon
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
            """The model's block of a global (..., nlat, nlon) field."""
            return torch.as_tensor(np.ascontiguousarray(
                x[..., self.rows, self.cols]), dtype=self.dtype, device=dev)

        zeros = t(np.zeros(shape))
        spec = dycore.spectral_state_from_grid(zeros, zeros, t(T), t(q),
                                               t(lnps))
        prev, now = dycore.initial_step(spec)
        grids = dycore.grids_of(prev)
        flat = np.zeros((nlat, nlon))
        aux = {'Ts': t(Ts2d), 'cbmf': t(flat), 'hr_rad': t(np.zeros(shape)),
               'sfc_rad': t(flat), 'olr': t(flat), 'asr': t(flat)}
        return prev, now, grids, aux, 0

    def _total_water(self, q_g, p_half):
        """Area-weighted mass-proxy integral sum(w * q * dp) over the
        sphere."""
        return self.dycore.sht.global_sum(
            self.wlat * q_g * (p_half[1:] - p_half[:-1]))

    def _fix_water(self, new, prev, phys):
        """Global multiplicative moisture mass fixer (moist_gcm.py:378),
        on spectral q or, in the 'sl' mode, on grid q (the 'fv' mode is
        conservative and never calls it)."""
        with phase('climt.fixer'):
            sht = self.dycore.sht
            q_prev = self.dycore._q_grid(prev)
            ps_prev = torch.exp(sht.synthesize(prev['lnps']))
            ph_prev, _, _, _ = self.dycore._vertical_structures(ps_prev)
            dp_prev = ph_prev[1:] - ph_prev[:-1]
            q_new = self.dycore._q_grid(new)
            ps_new = torch.exp(sht.synthesize(new['lnps']))
            ph_new, _, _, _ = self.dycore._vertical_structures(ps_new)
            q_pos = torch.clamp(q_new, min=0.0)
            # the three sums of _total_water's form, one reduction under a mesh
            src, tw_prev, tw_new = sht.global_sums(
                self.wlat * phys['dq'] * dp_prev, self.wlat * q_prev * dp_prev,
                self.wlat * q_pos * (ph_new[1:] - ph_new[:-1]))
            target = tw_prev + 2.0 * self.dt * src
            scale = torch.where(tw_new > 0.0,
                                torch.clamp(target, min=0.0) / tw_new, 1.0)
            q_fixed = q_pos * scale
            return dict(new, q=q_fixed if self.dycore.fv is not None
                        else sht.analyze(q_fixed))

    def _layout_twin(self, carry):
        """The rank-local twin of this model for a DTensor carry's mesh and
        layout, built at its first carry and kept; its surface geopotential
        is this model's block."""
        if self.dycore.sht.rows != slice(None):
            raise ValueError('a carry of shard_model_state is stepped by '
                             'the model built without a mesh')
        mesh, shard_lon = carry_layout(carry)
        key = (id(mesh), shard_lon)
        if key not in self._twins:
            self._twins[key] = (mesh, MoistGCM(
                mesh=mesh, layout='replicated', shard_lon=shard_lon,
                **self._args))
        twin = self._twins[key][1]
        twin.dycore.phi_s = self.dycore.phi_s[twin.rows, twin.cols]
        return twin, mesh, shard_lon

    def step(self, carry, _=None):
        """One model step: carry -> (carry, diagnostics) (:404).  A carry
        of ``shard_model_state`` is stepped by the rank-local twin and
        comes back in its layout, the diagnostics as grid fields."""
        with phase('climt.step'):
            if carry_layout(carry) is not None:
                return self._run_placed(carry, 1)
            prev, now, prev_grids, aux, k = carry
            phys, aux_new, diag = self.physics(prev_grids, aux, k)
            with phase('climt.dynamics'):
                filtered, new, now_grids = self.dycore.step(prev, now,
                                                            phys=phys)
            if self.conserve_water:
                new = self._fix_water(new, prev, phys)
            return (filtered, new, now_grids, aux_new, k + 1), diag

    def run(self, carry, n_steps):
        """n_steps model steps; returns (carry, last diagnostics) (:412)."""
        if carry_layout(carry) is not None:
            return self._run_placed(carry, n_steps)
        diag = None
        for _ in range(n_steps):
            carry, diag = self.step(carry)
        return carry, diag

    def _run_placed(self, carry, n_steps):
        """n_steps of the twin on a DTensor carry's blocks, unwrapped once
        and wrapped once."""
        twin, mesh, shard_lon = self._layout_twin(carry)
        local, diag = twin.run(unwrap_carry(carry), n_steps)
        if diag is None:
            return wrap_carry(mesh, local, shard_lon), None
        out = wrap_carry(mesh, local + (diag,), shard_lon)
        return out[:5], out[5]


def build_moist_gcm(nlon=128, nlat=64, nz=28, timestep=600.0,
                    number_of_damped_levels=5, ocean_depth=5.0,
                    dtype=torch.float32, fft_impl='fft', rad_every=6,
                    rad_col_chunk=8192, conserve_water=True, mesh=None,
                    moisture_advection='spectral', device='cuda'):
    """Return (dycore, init_fn, step_fn, run_fn) for the full moist GCM
    (moist_gcm.py:276), on ``device``: the CUDA card unless the caller
    asks for another (``device='cpu'``); without a card the default
    raises.

    run_fn(carry, n_steps) -> (carry, last_diag); carry = (prev, now,
    grids, aux, k) with k the global step index (a Python int), which
    drives the radiation cadence and the diurnal cycle.

    moisture_advection: 'spectral', 'fv' or 'sl'.  'fv' is locally
    conservative, so the global water fixer is off; 'sl' is not, and
    keeps it on, acting on the grid q.

    fft_impl: the zonal transform, 'fft' (``torch.fft``) or 'matmul'
    (the truncated DFT as real matmuls, ``ops.sht``); every layout's
    transforms take it.

    mesh: a ``torch.distributed`` ``DeviceMesh`` with a 'lat' axis
    (``parallel.make_mesh``), the production multi-GPU layout: every rank
    builds the model and runs it on its latitude block, with the spectral
    state m-sharded through ``parallel.DistributedSHT``.  The carry then
    holds the rank's blocks (``convert.carry_to_rank`` and
    ``convert.carry_to_global`` move a global carry in and out), and the
    diagnostics the rank's rows.

    A model built without a mesh also steps the replicated-spectral
    layout, JAX's ``shard_model_state`` placement:
    ``carry = parallel.shard_model_state(mesh, *init_fn(),
    shard_lon=...)``, then ``run_fn(carry, n)`` (see ``MoistGCM``)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(
            'mesh: expected a torch.distributed.device_mesh.DeviceMesh '
            '(climt_tpu_torch.parallel.make_mesh), got %r' % (mesh,))
    if moisture_advection == 'fv':
        conserve_water = False        # FV is conservative by construction
    device = resolve_device(device)
    model = MoistGCM(nlon, nlat, nz, timestep, number_of_damped_levels,
                     ocean_depth, dtype, rad_every, rad_col_chunk,
                     conserve_water, device, moisture_advection, mesh,
                     fft_impl=fft_impl)
    return model.dycore, model.init, model.step, model.run
