"""Semi-Lagrangian tracer transport on the Gaussian grid
(climt_tpu/ops/sl_advection.py).

Two-time-level midpoint trajectories (a fixed-point iteration, ``n_iter``
passes) give each arrival point's departure point; the field is
interpolated there bilinearly in (longitude, latitude-row index), which
is monotone; then the same upwind vertical pass as ``FVAdvection`` runs
on the dycore's interface mass flux.  Unconditionally stable in the
zonal direction, non-conservative (the dycore's global water fixer stays
on for it).  The Gaussian latitudes are inverted through a fine uniform
table and one refinement against the grid rows; each bilinear corner is
one flattened gather.

``advect`` runs inside the span ``climt.transport``.  The class counts
its four-corner gathers in ``SLAdvection.gathers`` and their bytes in
``SLAdvection.gather_bytes``: a gather of n output points of itemsize s
reads n values and n int64 indices and writes n values, n (2 s + 8)
bytes.  A step makes 2 ``n_iter`` + 1 interpolations of 4 gathers each
(u and v at the midpoint every iteration, then q), 20 at ``n_iter`` = 2:
at T85 (28 x 128 x 256 float32 points) 20 x 917,504 x 16 B = 293.6 MB.

Fields are (..., nz, nlat, nlon) top-down with latitude row 0
northernmost, as in ``FVAdvection``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.util import resolve_device
from ..utils.profiling import phase
from .fv_advection import vertical_upwind

# JAX's floor on the trajectory midpoint's cos(latitude)
# (sl_advection.py:148-149); kept for parity although it under-displaces
# the polar rows of fine grids
COS_FLOOR = 0.05


class SLAdvection(nn.Module):
    """Semi-Lagrangian transport operator for one grid; ``advect`` has
    ``FVAdvection.advect``'s signature."""

    gathers = 0
    gather_bytes = 0

    def __init__(self, mu, weights, nlon, radius, dt_max,
                 dtype=torch.float32, n_iter=2, table_oversample=8,
                 device='cuda'):
        """``device``: the CUDA card unless the caller asks for another
        (``device='cpu'``); without a card the default raises."""
        super().__init__()
        device = resolve_device(device)
        del dt_max                               # stable at any Courant
        mu = np.asarray(mu, np.float64)
        self.nlat = mu.shape[0]
        self.nlon = nlon
        self.radius = radius
        self.dtype = dtype
        self.n_iter = n_iter
        phi = np.arcsin(mu)                      # descending (N -> S)
        self.dlam = 2.0 * math.pi / nlon

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dtype, device=device))

        buf('_w', np.asarray(weights, np.float64))
        buf('_phi', phi)
        buf('_coslat', np.cos(phi))
        # the clip bounds, the grid's first and last latitude in dtype
        self._phi_n = float(self._phi[0])
        self._phi_s = float(self._phi[-1])
        # fractional descending-row index on a uniform fine table over
        # [phi_S, phi_N] (sl_advection.py:74-84)
        nt = table_oversample * self.nlat
        phi_asc = phi[::-1]
        tbl_phi = np.linspace(phi_asc[0], phi_asc[-1], nt)
        idx_asc = np.interp(tbl_phi, phi_asc, np.arange(self.nlat))
        buf('_lat_tbl', (self.nlat - 1) - idx_asc)
        self._tbl_phi0 = float(tbl_phi[0])
        self._tbl_dphi = float(tbl_phi[1] - tbl_phi[0])
        self._tbl_n = nt

    # -- fractional grid coordinates --------------------------------------
    def _lat_index(self, phi):
        """Fractional descending-row index of latitude phi, clamped: the
        table's estimate, then one refinement against the grid rows
        (sl_advection.py:87).  The indices act on clipped non-negative
        values, so truncation is the floor."""
        x = (phi - self._tbl_phi0) / self._tbl_dphi
        x = torch.clamp(x, 0.0, self._tbl_n - 1.0)
        i0 = torch.clamp(x.long(), 0, self._tbl_n - 2)
        f = x - i0
        t = self._lat_tbl
        est = t[i0] * (1.0 - f) + t[i0 + 1] * f
        j0 = torch.clamp(est.long(), 0, self.nlat - 2)
        phi0 = self._phi[j0]
        phi1 = self._phi[j0 + 1]
        frac = (phi0 - phi) / (phi0 - phi1)       # phi descending
        return torch.clamp(j0 + frac, 0.0, float(self.nlat - 1))

    def _interp(self, field, lam_idx, lat_idx):
        """Monotone bilinear interpolation of ``field`` (..., nz, nlat,
        nlon) at fractional (longitude index, latitude row) points of
        shape (nz, nlat, nlon): one flattened gather per corner
        (sl_advection.py:106)."""
        nlat, nlon = self.nlat, self.nlon
        i0 = torch.floor(lam_idx).long()
        fx = (lam_idx - i0).to(field.dtype)
        i0 = torch.remainder(i0, nlon)
        i1 = torch.remainder(i0 + 1, nlon)
        j0 = torch.clamp(torch.floor(lat_idx).long(), 0, nlat - 2)
        fy = torch.clamp(lat_idx - j0, 0.0, 1.0).to(field.dtype)
        j1 = j0 + 1

        nz = lam_idx.shape[0]
        flat = field.reshape(field.shape[:-2] + (nlat * nlon,))

        def corner(j, i):
            idx = (j * nlon + i).reshape(nz, -1)
            idx = idx.expand(flat.shape[:-2] + idx.shape)
            SLAdvection.gathers += 1
            SLAdvection.gather_bytes += idx.numel() * (
                2 * flat.element_size() + idx.element_size())
            return torch.gather(flat, -1, idx).reshape(field.shape)

        q00 = corner(j0, i0)
        q01 = corner(j0, i1)
        q10 = corner(j1, i0)
        q11 = corner(j1, i1)
        top = q00 + fx * (q01 - q00)
        bot = q10 + fx * (q11 - q10)
        return top + fy * (bot - top)

    # -- departure points --------------------------------------------------
    def _departure(self, u, v, dt):
        """Fractional (longitude, latitude-row) indices of the departure
        points by midpoint fixed-point iteration (sl_advection.py:136)."""
        lam_a = torch.arange(self.nlon, dtype=self.dtype,
                             device=u.device) * self.dlam
        lam_a = torch.broadcast_to(lam_a, u.shape)
        phi_a = torch.broadcast_to(self._phi[:, None], u.shape)

        # first guess: the arrival point's velocity over the whole step
        u_m, v_m = u, v
        lam_d, phi_d = lam_a, phi_a
        for _ in range(self.n_iter):
            cos_m = torch.clamp(torch.cos(0.5 * (phi_a + phi_d)),
                                min=COS_FLOOR)
            alpha = u_m * dt / (self.radius * cos_m)
            beta = v_m * dt / self.radius
            lam_d = lam_a - alpha
            phi_d = torch.clamp(phi_a - beta, self._phi_s, self._phi_n)
            # the midpoint's velocity for the next pass
            lam_m = lam_a - 0.5 * alpha
            phi_m = torch.clamp(phi_a - 0.5 * beta, self._phi_s,
                                self._phi_n)
            lam_im = lam_m / self.dlam
            lat_im = self._lat_index(phi_m)
            u_m = self._interp(u, lam_im, lat_im)
            v_m = self._interp(v, lam_im, lat_im)
        return lam_d / self.dlam, self._lat_index(phi_d)

    def advect(self, q, dp, u, v, mdot, dt):
        """One semi-Lagrangian transport step over ``dt``.

        q (..., nz, nlat, nlon); dp, u, v (nz, nlat, nlon); mdot (nz-1,
        nlat, nlon).  Returns the transported mixing ratio; the
        horizontal pass is advective-form, not conservative."""
        with phase('climt.transport'):
            lam_idx, lat_idx = self._departure(u, v, dt)
            q_h = self._interp(q, lam_idx, lat_idx)
            return vertical_upwind(q_h, dp, mdot, dt)[0]

    def total_mass(self, q, dp):
        """Area-weighted tracer mass (a diagnostic: ``advect`` does not
        conserve it)."""
        return torch.sum(q * dp * self._w[:, None])
