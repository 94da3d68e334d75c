"""Flux-form finite-volume tracer transport on the Gaussian grid
(climt_tpu/ops/fv_advection.py).

Conservative van Leer (MUSCL, monotonized-central limiter) transport in
the (lambda, mu) coordinates of the Gaussian grid, then upwind vertical
transport on the dycore's interface mass flux, in the Lin & Rood (1996)
consistent form:

  (q dp)^+ = (q dp)^- - dt [div_h(V dp q_face) + delta_k(mdot q_face)]
     dp*^+ =      dp^- - dt [div_h(V dp)       + delta_k(mdot)      ]
       q^+ = (q dp)^+ / dp*^+

so a constant mixing ratio stays exactly constant and sum(q dp w) is
conserved to roundoff (every face flux telescopes; the polar faces are
closed).  Fields are (..., nz, nlat, nlon) top-down with latitude row 0
northernmost: level, latitude and longitude are the last three axes, so
one call transports a batch of tracers (ntr, nz, nlat, nlon) on one set
of (nz, nlat, nlon) winds and layer thicknesses.

The zonal Courant number grows toward the poles, so the zonal pass
substeps per latitude band with power-of-two counts sized for ``dt_max``
and ``max_wind``.  A row's zonal update depends on that row alone, so the
rows of every band with the same count (a northern band and its southern
mirror) go through one loop of that many substeps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.util import resolve_device
from ..utils.profiling import phase


def _mc_slope(qm, q0, qp):
    """Monotonized-central limited slope from (left, centre, right)."""
    dc = 0.5 * (qp - qm)
    d1 = 2.0 * (q0 - qm)
    d2 = 2.0 * (qp - q0)
    s = torch.sign(dc)
    mag = torch.minimum(torch.abs(dc),
                        torch.minimum(torch.abs(d1), torch.abs(d2)))
    return torch.where(d1 * d2 > 0.0, s * mag, 0.0)


def _vanleer_face(q_up, slope_up, c_abs):
    """Upwind van Leer face value: q_up + 0.5 slope (1 - |c|)."""
    return q_up + 0.5 * slope_up * (1.0 - c_abs)


def vertical_upwind(q, dp, mdot, dt):
    """Upwind transport over dt on the interface mass flux ``mdot``
    (..., nz-1, nlat, nlon), Pa/s, positive toward larger level index.
    Returns (q, dp*) after the pass (fv_advection.py:197,
    sl_advection.py:166)."""
    q_up = torch.where(mdot >= 0.0, q[..., :-1, :, :], q[..., 1:, :, :])
    F = mdot * q_up * dt                              # interior faces
    zero = torch.zeros_like(q[..., :1, :, :])
    zero_m = torch.zeros_like(dp[..., :1, :, :])
    F_full = torch.cat([zero, F, zero], dim=-3)
    M_full = torch.cat([zero_m, mdot * dt, zero_m], dim=-3)
    Q = q * dp - (F_full[..., 1:, :, :] - F_full[..., :-1, :, :])
    dp = dp - (M_full[..., 1:, :, :] - M_full[..., :-1, :, :])
    return Q / dp, dp


class FVAdvection(nn.Module):
    """Conservative flux-form transport operator for one grid."""

    def __init__(self, mu, weights, nlon, radius, dt_max,
                 dtype=torch.float32, max_wind=120.0, device='cuda',
                 halo_exchange=None):
        """``dt_max`` is the longest interval ``advect`` will be called
        with (2 dt under leapfrog); the zonal substep counts are sized for
        it and ``max_wind`` (a CFL bound, not an accuracy knob), as in
        fv_advection.py:68.

        ``halo_exchange``: for a latitude-sharded mesh, a
        ``parallel.halo.make_lat_halo`` callable; ``_shift_north`` and
        ``_shift_south`` then go through it.  ``mu`` and ``weights`` stay
        the global grid's; the operator keeps the rows of the halo's
        latitude block (its ``index`` of ``size``), so fields are that
        block's (..., nz, nlat/size, nlon), the zonal band loops run over
        its rows only, and ``total_mass`` is all-reduced over the halo's
        group.

        ``device``: the CUDA card unless the caller asks for another
        (``device='cpu'``); without a card the default raises."""
        super().__init__()
        device = resolve_device(device)
        mu = np.asarray(mu, np.float64)
        w = np.asarray(weights, np.float64)
        nlat = mu.shape[0]
        self.nlon = nlon
        self.radius = radius
        self.dt_max = float(dt_max)
        self.dtype = dtype
        self.halo_exchange = halo_exchange
        block = slice(None)
        if halo_exchange is not None:
            if nlat % halo_exchange.size:
                raise ValueError('nlat %d is not divisible by %d latitude '
                                 'blocks' % (nlat, halo_exchange.size))
            n = nlat // halo_exchange.size
            block = slice(halo_exchange.index * n,
                          (halo_exchange.index + 1) * n)
        coslat = np.sqrt(1.0 - mu ** 2)
        dlam = 2.0 * math.pi / nlon
        dx = radius * coslat * dlam                       # (nlat,)
        wf = 0.5 * (w[1:] + w[:-1])                       # face Delta-mu
        wface = np.concatenate([wf, wf[-1:]])
        # only the global last face (the south pole) is closed
        face_ok = np.arange(nlat) < nlat - 1
        dx, w, coslat = dx[block], w[block], coslat[block]
        wface, face_ok = wface[block], face_ok[block]
        self.nlat = dx.shape[0]
        n_sub = np.maximum(
            1, np.ceil(max_wind * self.dt_max / dx)).astype(int)
        n_sub = 2 ** np.ceil(np.log2(n_sub)).astype(int)
        bands = []                                        # (j0, j1, n)
        j0 = 0
        for j in range(1, self.nlat + 1):
            if j == self.nlat or n_sub[j] != n_sub[j0]:
                bands.append((j0, j, int(n_sub[j0])))
                j0 = j
        self.zonal_bands = bands
        # the rows of each substep count, in band order, and the order
        # that puts the concatenated groups back in row order
        counts = sorted({n for _, _, n in bands})
        rows = [np.concatenate([np.arange(a, b) for a, b, n in bands
                                if n == count]) for count in counts]
        order = np.concatenate(rows)
        self.zonal_counts = counts

        def buf(name, arr, dt=dtype):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dt, device=device))

        for i, r in enumerate(rows):
            buf('_rows%d' % i, r, torch.long)
        buf('_unorder', np.argsort(order), torch.long)
        buf('_dx', dx)
        buf('_w', w)                                      # Delta-mu_j
        buf('_coslat', coslat)
        buf('_wface_full', wface[:, None])
        buf('_face_ok', face_ok[:, None])

    # -- zonal (periodic, substepped) -------------------------------------
    def _zonal_rows(self, q, dp, u, dxj, n, dt):
        """n substeps of 1-D zonal van Leer on a set of rows.

        q (..., nz, rows, nlon); dp, u (nz, rows, nlon); dxj (rows,).
        Returns (q, dp) (fv_advection.py:109)."""
        dt_s = dt / n
        u_face = 0.5 * (u + torch.roll(u, -1, dims=-1))   # face i+1/2
        dp_face = 0.5 * (dp + torch.roll(dp, -1, dims=-1))
        inv_dx = (dt_s / dxj)[:, None]
        M = u_face * dp_face * inv_dx                     # face mass flux
        c_abs = torch.abs(u_face) * inv_dx
        up_pos = M >= 0.0
        dM = M - torch.roll(M, 1, dims=-1)
        for _ in range(n):
            qm = torch.roll(q, 1, dims=-1)
            qp = torch.roll(q, -1, dims=-1)
            s = _mc_slope(qm, q, qp)
            sp = torch.roll(s, -1, dims=-1)
            # upwind from the left cell (M >= 0): q_i + 0.5 s_i (1-|c|);
            # from the right cell: q_{i+1} - 0.5 s_{i+1} (1-|c|)
            q_face = torch.where(up_pos, _vanleer_face(q, s, c_abs),
                                 qp - 0.5 * sp * (1.0 - c_abs))
            F = M * q_face
            Q = q * dp - (F - torch.roll(F, 1, dims=-1))
            dp = dp - dM
            q = Q / dp
        return q, dp

    def _zonal(self, q, dp, u, dt):
        qs, dps = [], []
        for i, n in enumerate(self.zonal_counts):
            rows = getattr(self, '_rows%d' % i)
            qb, dpb = self._zonal_rows(
                q.index_select(-2, rows), dp.index_select(-2, rows),
                u.index_select(-2, rows), self._dx[rows], n, dt)
            qs.append(qb)
            dps.append(dpb)
        if len(qs) == 1:
            return qs[0], dps[0]
        return (torch.cat(qs, dim=-2).index_select(-2, self._unorder),
                torch.cat(dps, dim=-2).index_select(-2, self._unorder))

    # -- meridional (closed poles) ----------------------------------------
    def _shift_north(self, x):
        """Row j of the result = row j-1 of x (northern neighbour); row 0
        zero (pole)."""
        if self.halo_exchange is not None:
            return self.halo_exchange(x, +1)
        return torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]],
                         dim=-2)

    def _shift_south(self, x):
        if self.halo_exchange is not None:
            return self.halo_exchange(x, -1)
        return torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])],
                         dim=-2)

    def _meridional(self, q, dp, v, dt):
        """Flux-form van Leer in mu.  Face j+1/2 sits between rows j and
        j+1 (mu decreasing); v > 0 carries mass from row j+1 to row j
        (fv_advection.py:164)."""
        vc = v * self._coslat[:, None]
        q_s = self._shift_south(q)                        # row j+1 values
        dp_s = self._shift_south(dp)
        vc_s = self._shift_south(vc)
        # faces 0..nlat-2 are real; the last is the south pole
        vc_face = 0.5 * (vc + vc_s) * self._face_ok
        dp_face = 0.5 * (dp + dp_s)
        c_abs = torch.abs(vc_face) * dt / (self.radius * self._wface_full)

        s = _mc_slope(self._shift_north(q), q, q_s)
        s_s = self._shift_south(s)
        q_face = torch.where(vc_face <= 0.0,
                             _vanleer_face(q, s, c_abs),
                             q_s - 0.5 * s_s * (1.0 - c_abs))
        G = vc_face * dp_face * q_face                    # face j+1/2
        G_n = self._shift_north(G)                        # face j-1/2
        fac = (dt / self.radius) / self._w[:, None]
        Q = q * dp - fac * (G_n - G)
        mass = vc_face * dp_face
        dp = dp - fac * (self._shift_north(mass) - mass)
        return Q / dp, dp

    # -- vertical ---------------------------------------------------------
    @staticmethod
    def _vertical(q, dp, mdot, dt):
        return vertical_upwind(q, dp, mdot, dt)

    def advect(self, q, dp, u, v, mdot, dt):
        """One conservative transport step over ``dt`` (<= dt_max).

        q (..., nz, nlat, nlon); dp, u, v (nz, nlat, nlon); mdot (nz-1,
        nlat, nlon).  Returns the transported mixing ratio, q's shape."""
        with phase('climt.transport'):
            q, dp = self._zonal(q, dp, u, dt)
            q, dp = self._meridional(q, dp, v, dt)
            q, _ = self._vertical(q, dp, mdot, dt)
        return q

    def total_mass(self, q, dp):
        """Area-weighted tracer mass sum q dp w_j (conserved by
        ``advect`` to roundoff); over the whole sphere under a halo."""
        mass = torch.sum(q * dp * self._w[:, None])
        if self.halo_exchange is not None:
            dist.all_reduce(mass, group=self.halo_exchange.group)
        return mass
