"""Semi-implicit spectral primitive-equation step of the plain
reference, one device, spectral or FV moisture."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .fv import FVAdvection
from .sht import SphericalHarmonicTransform


class SpectralDycore(nn.Module):
    """Semi-implicit spectral primitive-equation solver."""

    def __init__(self, nlon, nlat, nz, ak, bk,
                 truncation=None,
                 timestep=600.0,
                 reference_temperature=300.0,
                 reference_surface_pressure=1e5,
                 hyperdiffusion_timescale=None,
                 number_of_damped_levels=0,
                 damping_timescale=2.0 * 86400.0,
                 asselin_strength=0.05,
                 rd=287.0, cpd=1004.64, g=9.80665,
                 radius=6.371e6, omega=7.292e-5,
                 dtype=torch.float64, moisture_advection='spectral',
                 fv_max_wind=120.0, device='cuda'):
        """``ak``, ``bk``: bottom-up interface coefficients with
        p_interface = ak + bk (ps - p_top).  ``moisture_advection``:
        'spectral' (advective form) or 'fv' (conservative flux-form
        transport in grid space on the dycore's mass fluxes); in 'fv' the
        state's 'q' is a grid field (nz, nlat, nlon)."""
        super().__init__()
        self.nlon, self.nlat, self.nz = nlon, nlat, nz
        self.sht = SphericalHarmonicTransform(
            nlon, nlat, truncation, radius=radius, dtype=dtype,
            device=device)
        ncol = nlon
        T = self.sht.truncation
        self.dtype = dtype
        self.rd, self.cpd, self.g = rd, cpd, g
        self.kappa = rd / cpd
        self.radius, self.omega = radius, omega
        self.dt = timestep
        self.asselin = asselin_strength

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dtype, device=device))

        ak = np.asarray(ak, dtype=np.float64)
        bk = np.asarray(bk, dtype=np.float64)
        p_top = ak[-1]
        A_np = (ak - bk * p_top)[::-1].copy()          # (nz+1,) top..sfc
        B_np = bk[::-1].copy()
        buf('A', A_np)
        buf('B', B_np)
        self.register_buffer('dB', torch.diff(self.B))

        mu = self.sht.mu
        buf('f_grid', (2.0 * omega * mu)[:, None] * np.ones((1, ncol)))
        buf('coslat', np.sqrt(1.0 - mu ** 2))

        # reference-state vertical structure for the semi-implicit solve
        ps_ref = reference_surface_pressure
        t_ref = reference_temperature
        self.t_ref, self.ps_ref = t_ref, ps_ref
        p_half = A_np + B_np * ps_ref
        dp = np.diff(p_half)
        ln_ratio = np.log(p_half[1:] / p_half[:-1])
        alpha = 1.0 - (p_half[:-1] / dp) * ln_ratio
        alpha[0] = np.log(2.0)          # GFS top-layer convention
        G = np.zeros((nz, nz))
        for k in range(nz):
            G[k, k] = rd * alpha[k]
            for j in range(k + 1, nz):
                G[k, j] = rd * ln_ratio[j]
        r_vec = np.full(nz, rd * t_ref)
        tau = np.zeros((nz, nz))
        for k in range(nz):
            for j in range(k):
                tau[k, j] = self.kappa * t_ref * ln_ratio[k] * dp[j] / dp[k]
            tau[k, k] = self.kappa * t_ref * alpha[k]
        sigma = dp / ps_ref
        M = G @ tau + np.outer(r_vec, sigma)
        buf('G', G)
        buf('tau', tau)
        buf('sigma', sigma)
        buf('r_vec', r_vec)
        buf('M', M)

        # per-total-wavenumber implicit inverses (I + dt^2 L_n M)^-1
        n = np.arange(T + 1)
        L = n * (n + 1.0) / radius ** 2
        eye = np.eye(nz)
        buf('Minv', np.stack([
            np.linalg.inv(eye + (timestep ** 2) * L[i] * M)
            for i in range(T + 1)]))                     # (N+1, nz, nz)
        n2d = np.broadcast_to(n[None, :], (T + 1, T + 1))
        buf('L_2d', n2d * (n2d + 1.0) / radius ** 2)    # n(n+1)/a^2

        # del^8 hyperdiffusion, implicit per-step factors (:182-201)
        if hyperdiffusion_timescale is None:
            hyperdiffusion_timescale = 26157.6
        nmax = max(T, 1)
        k_n = ((n * (n + 1.0) / (nmax * (nmax + 1.0))) ** 4
               / hyperdiffusion_timescale)
        k2d = np.broadcast_to(k_n[None, :], (T + 1, T + 1))
        buf('hyperdiff_factor', 1.0 / (1.0 + 2.0 * timestep * k2d))
        buf('hyperdiff_factor_start', 1.0 / (1.0 + timestep * k2d))

        buf('phi_s', np.zeros((mu.shape[0], ncol)))

        damp = np.zeros(nz)
        for lev in range(number_of_damped_levels):
            damp[lev] = (1.0 / damping_timescale) * (
                (number_of_damped_levels - lev) / number_of_damped_levels)
        buf('rayleigh', damp)

        if moisture_advection not in ('spectral', 'fv'):
            raise ValueError(moisture_advection)
        self.moisture_advection = moisture_advection
        self.fv = None
        if moisture_advection == 'fv':
            self.fv = FVAdvection(
                self.sht.mu, self.sht.weights, nlon, radius,
                dt_max=2.0 * timestep, dtype=dtype, max_wind=fv_max_wind,
                device=device)

    # ------------------------------------------------------------------
    def spectral_state_from_grid(self, u, v, T, q, lnps):
        """Grid (nz, nlat, nlon) top-down fields -> spectral state dict."""
        U = u * self.coslat[:, None]
        V = v * self.coslat[:, None]
        grid_q = self.fv is not None
        specs, ((vort, div),) = self.sht.analyze_many(
            [T, lnps] + ([] if grid_q else [q]), [(U, V)])
        return {'vort': vort, 'div': div, 'T': specs[0],
                'q': q if grid_q else specs[2], 'lnps': specs[1]}

    def _q_grid(self, spec):
        """The grid moisture of a state: its own 'q' in the grid modes."""
        return spec['q'] if self.fv is not None else self.sht.synthesize(
            spec['q'])

    def _vertical_structures(self, ps):
        """Pressure structure from surface pressure (nlat, nlon)."""
        p_half = self.A[:, None, None] + self.B[:, None, None] * ps[None]
        dp = p_half[1:] - p_half[:-1]
        ln_ratio = torch.log(p_half[1:] / p_half[:-1])
        alpha = 1.0 - (p_half[:-1] / dp) * ln_ratio
        alpha = torch.cat(
            [torch.full_like(alpha[:1], math.log(2.0)), alpha[1:]], dim=0)
        return p_half, dp, ln_ratio, alpha

    def explicit_tendencies(self, spec, phys=None, physics_fn=None):
        """Full nonlinear tendencies at the centre time level
        (spectral_dynamics.py:283).  ``phys`` optionally carries grid
        physics tendencies {du, dv, dT, dq} (top-down); ``physics_fn``
        instead computes them from the synthesized grid fields."""
        sht = self.sht
        u, v = sht.uv_from_vort_div(spec['vort'], spec['div'])
        vort_g = sht.synthesize(spec['vort'])
        div_g = sht.synthesize(spec['div'])
        T_g = sht.synthesize(spec['T'])
        q_g = self._q_grid(spec)
        lnps_g = sht.synthesize(spec['lnps'])
        ps = torch.exp(lnps_g)

        dlnps_dx, dlnps_dy = sht.gradient(spec['lnps'])
        p_half, dp, ln_ratio, alpha = self._vertical_structures(ps)
        Tv = T_g * (1.0 + 0.608 * q_g)
        if physics_fn is not None:
            if phys is not None:
                raise ValueError('pass phys or physics_fn, not both')
            phys = physics_fn({'u': u, 'v': v, 'T': T_g, 'q': q_g, 'ps': ps,
                               'p_half': p_half, 'dp': dp})

        v_dot_gradlnps = u * dlnps_dx[None] + v * dlnps_dy[None]
        S = dp * div_g + ps[None] * self.dB[:, None, None] * v_dot_gradlnps
        S_cum = torch.cumsum(S, dim=0)
        S_below = S_cum - S
        S_total = S_cum[-1]
        dlnps_dt = -S_total / ps
        mdot = self.B[1:-1, None, None] * S_total[None] - S_cum[:-1]

        def vadv(X):
            flux = mdot * (X[1:] - X[:-1])     # interior half levels
            zero = torch.zeros_like(X[:1])
            out = (torch.cat([flux, zero], dim=0)
                   + torch.cat([zero, flux], dim=0))
            return out / (2.0 * dp)

        c_k = (ln_ratio * self.B[:-1, None, None] + alpha
               * self.dB[:, None, None]) * ps[None] / dp
        pgrad_x = self.rd * Tv * c_k * dlnps_dx[None]
        pgrad_y = self.rd * Tv * c_k * dlnps_dy[None]

        abs_vort = vort_g + self.f_grid[None]
        Nu = abs_vort * v - vadv(u) - pgrad_x
        Nv = -abs_vort * u - vadv(v) - pgrad_y
        if phys is not None:
            Nu = Nu + phys['du']
            Nv = Nv + phys['dv']
        Nu = Nu - self.rayleigh[:, None, None] * u
        Nv = Nv - self.rayleigh[:, None, None] * v

        cosl = self.coslat[:, None]
        kinetic = 0.5 * (u ** 2 + v ** 2)
        rtv_ln = self.rd * Tv * ln_ratio
        below = torch.flip(torch.cumsum(torch.flip(rtv_ln, [0]), dim=0), [0])
        phi_full = self.phi_s + (below - rtv_ln) + self.rd * Tv * alpha

        dT_dx, dT_dy = sht.gradient(spec['T'])
        omega_over_p = (c_k * v_dot_gradlnps
                        - (ln_ratio * S_below + alpha * S) / dp)
        dT_dt_grid = (-u * dT_dx - v * dT_dy - vadv(T_g)
                      + self.kappa * Tv * omega_over_p)
        if phys is not None:
            dT_dt_grid = dT_dt_grid + phys['dT']

        # moisture: the spectral advective form, or in the grid modes the
        # physics source alone (step() transports q in grid space)
        to_analyze = [kinetic + phi_full, dT_dt_grid, dlnps_dt]
        if self.fv is not None:
            q_tend = phys['dq'] if phys is not None else torch.zeros_like(
                q_g)
        else:
            dq_dx, dq_dy = sht.gradient(spec['q'])
            dq_dt_grid = -u * dq_dx - v * dq_dy - vadv(q_g)
            if phys is not None:
                dq_dt_grid = dq_dt_grid + phys['dq']
            to_analyze.append(dq_dt_grid)

        specs, ((dvort_dt, ddiv_dt),) = sht.analyze_many(
            to_analyze, [(Nu * cosl, Nv * cosl)])
        ddiv_dt = ddiv_dt - sht.laplacian(specs[0])
        if self.fv is None:
            q_tend = specs[3]
        tend = {'vort': dvort_dt, 'div': ddiv_dt, 'T': specs[1],
                'q': q_tend, 'lnps': specs[2]}
        if self.fv is not None:
            tend['mdot'] = mdot             # for the vertical pass
        grids = {'u': u, 'v': v, 'T': T_g, 'q': q_g, 'ps': ps,
                 'p_half': p_half, 'dp': dp}
        return tend, grids

    # ------------------------------------------------------------------
    # level-coupling products on complex spectral fields (:412-433)
    @staticmethod
    def _apply_matrix(mat, x):
        """(nz, nz) x (nz, M, N) -> (nz, M, N)."""
        return torch.complex(torch.einsum('kj,jmn->kmn', mat, x.real),
                             torch.einsum('kj,jmn->kmn', mat, x.imag))

    @staticmethod
    def _apply_batched_inverse(Minv, x):
        """(N+1, nz, nz) per-wavenumber solve applied to (nz, M, N)."""
        return torch.complex(torch.einsum('nkj,jmn->kmn', Minv, x.real),
                             torch.einsum('nkj,jmn->kmn', Minv, x.imag))

    @staticmethod
    def _apply_vector(vec, x):
        """(nz,) . (nz, M, N) -> (M, N)."""
        return torch.complex(torch.einsum('j,jmn->mn', vec, x.real),
                             torch.einsum('j,jmn->mn', vec, x.imag))

    def step(self, prev, now, phys=None, dt=None, physics_fn=None,
             prev_grids=None):
        """One semi-implicit leapfrog step (spectral_dynamics.py:435).

        ``phys``: grid physics tendencies {du, dv, dT, dq} (top-down), at
        whichever time level the caller chose.  ``dt``: the timestep,
        the construction timestep when None; the implicit inverses and the
        hyperdiffusion factors are built for that one.  ``physics_fn``: a
        function of a grid-state dict giving the tendencies, evaluated on
        ``prev_grids`` (lagged physics) when given, else on the centre
        grids.  Returns (filtered_now, new, now_grids)."""
        dt = self.dt if dt is None else dt
        if physics_fn is not None and prev_grids is not None:
            phys = physics_fn(prev_grids)
            physics_fn = None
        tend, now_grids = self.explicit_tendencies(now, phys, physics_fn)

        two_dt = 2.0 * dt
        T_expl = prev['T'] + two_dt * tend['T']
        if self.fv is not None:
            # grid-space transport from t-dt over 2 dt on the centre
            # winds and mass fluxes, plus the physics source
            q_expl = self.fv.advect(
                prev['q'], self._dp_of(prev['lnps']), now_grids['u'],
                now_grids['v'], tend['mdot'], two_dt) + two_dt * tend['q']
        else:
            q_expl = prev['q'] + two_dt * tend['q']
        lnps_expl = prev['lnps'] + two_dt * tend['lnps']
        vort_new = prev['vort'] + two_dt * tend['vort']
        D_expl = prev['div'] + two_dt * tend['div']

        L = self.L_2d
        G_T = self._apply_matrix(self.G, (T_expl + prev['T']) * 0.5
                                 - now['T'])
        r_q = self.r_vec[:, None, None] * (
            (lnps_expl + prev['lnps']) * 0.5 - now['lnps'])
        rhs = D_expl + two_dt * L[None] * (G_T + r_q)
        MD = self._apply_matrix(self.M, prev['div'] - 2.0 * now['div'])
        rhs = rhs - (dt ** 2) * L[None] * MD
        D_new = self._apply_batched_inverse(self.Minv, rhs)

        delta_D = 0.5 * (D_new + prev['div']) - now['div']
        T_new = T_expl - two_dt * self._apply_matrix(self.tau, delta_D)
        lnps_new = lnps_expl - two_dt * self._apply_vector(
            self.sigma, delta_D)

        new = {'vort': vort_new, 'div': D_new, 'T': T_new, 'q': q_expl,
               'lnps': lnps_new}
        # implicit hyperdiffusion; grid-space moisture takes none
        for key in self._diffused():
            new[key] = new[key] * self.hyperdiff_factor[None]
        filtered = {key: now[key] + self.asselin * (
            new[key] - 2.0 * now[key] + prev[key]) for key in new}
        return filtered, new, now_grids

    def _diffused(self):
        return ('vort', 'div', 'T') + (('q',) if self.fv is None else ())

    def _dp_of(self, lnps_spec):
        """Layer thicknesses (nz, nlat, nlon) of a spectral lnps."""
        ps = torch.exp(self.sht.synthesize(lnps_spec))
        p_half = self.A[:, None, None] + self.B[:, None, None] * ps[None]
        return p_half[1:] - p_half[:-1]

    def grids_of(self, spec):
        """Grid fields of a spectral state (seeds the lagged physics)."""
        sht = self.sht
        u, v = sht.uv_from_vort_div(spec['vort'], spec['div'])
        ps = torch.exp(sht.synthesize(spec['lnps']))
        p_half, dp, _, _ = self._vertical_structures(ps)
        return {'u': u, 'v': v, 'T': sht.synthesize(spec['T']),
                'q': self._q_grid(spec), 'ps': ps,
                'p_half': p_half, 'dp': dp}

    def initial_step(self, now, phys=None, dt=None, physics_fn=None):
        """Forward start: (now, state at t+dt) by a half-then-full step
        (:555) of ``dt``, the construction timestep when None;
        ``physics_fn`` is evaluated on both."""
        dt = self.dt if dt is None else dt
        tend, grids0 = self.explicit_tendencies(now, phys, physics_fn)
        if self.fv is None:
            half = {k: now[k] + 0.5 * dt * tend[k] for k in now}
            tend2, _ = self.explicit_tendencies(half, phys, physics_fn)
            new = {k: now[k] + dt * tend2[k] for k in now}
        else:
            # grid moisture: transported over dt/2 and then dt from the
            # initial state on the winds of each stage (:560-579)
            dp0 = self._dp_of(now['lnps'])
            half = {k: now[k] + 0.5 * dt * tend[k] for k in now
                    if k != 'q'}
            half['q'] = self.fv.advect(
                now['q'], dp0, grids0['u'], grids0['v'], tend['mdot'],
                0.5 * dt) + 0.5 * dt * tend['q']
            tend2, grids_h = self.explicit_tendencies(half, phys,
                                                      physics_fn)
            new = {k: now[k] + dt * tend2[k] for k in now if k != 'q'}
            new['q'] = self.fv.advect(
                now['q'], dp0, grids_h['u'], grids_h['v'], tend2['mdot'],
                dt) + dt * tend2['q']
        for key in self._diffused():
            new[key] = new[key] * self.hyperdiff_factor_start[None]
        return now, new
