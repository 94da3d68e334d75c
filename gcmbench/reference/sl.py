"""Semi-Lagrangian moisture transport of the plain reference, one device,
written from the method (Williamson and Rasch 1989, the two-time-level
midpoint form; CAM3's Eulerian core carries water vapour so).

A step of ``dt`` finds each arrival point's departure point by
``n_iter`` passes of the midpoint rule: the first pass moves it back
along the arrival point's wind; each later pass along the wind
interpolated at the midpoint of the previous pass's trajectory.  The
zonal displacement divides by the midpoint's cos(latitude), floored at
``COS_FLOOR``; latitudes are clipped to the grid's outermost rows.  The
field is then interpolated bilinearly at the departure point in
(longitude index, Gaussian-row index), which is monotone, and the
upwind vertical pass on the dycore's interface mass flux follows
(``fv.vertical_upwind``).  The transport does not conserve mass; the
GCM's water fixer restores the global total.

Departures from CAM3 (both shared with the program): bilinear and not
shape-preserving Hermite cubic interpolation, with the vertical moved
by the upwind pass; near the poles the floor on cos(latitude) in place
of a local geodesic frame.  The fractional row of a latitude comes from
``torch.searchsorted`` over the Gaussian latitudes, where the program
reads a fine uniform table and refines once against the rows.

Fields are (..., nz, nlat, nlon) top-down, latitude row 0 northernmost.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .fv import vertical_upwind

# the floor on the trajectory midpoint's cos(latitude)
COS_FLOOR = 0.05


class SLAdvection(nn.Module):
    """Semi-Lagrangian transport for one Gaussian grid; ``advect`` has
    ``fv.FVAdvection.advect``'s signature."""

    def __init__(self, mu, nlon, radius, n_iter=2, dtype=torch.float32,
                 device='cuda'):
        super().__init__()
        phi = np.arcsin(np.asarray(mu, np.float64))     # descending
        self.nlat = phi.shape[0]
        self.nlon = nlon
        self.radius = radius
        self.n_iter = n_iter
        self.dtype = dtype
        self.dlam = 2.0 * math.pi / nlon

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dtype, device=device))

        buf('phi', phi)
        buf('phi_ascending', phi[::-1])
        self.phi_north = float(self.phi[0])
        self.phi_south = float(self.phi[-1])

    def row_of(self, phi):
        """Fractional row index (0 the northernmost row) of latitudes
        ``phi`` inside the grid: linear in latitude between the two rows
        that bracket it."""
        asc = self.phi_ascending
        n = self.nlat
        k = torch.clamp(torch.searchsorted(asc, phi.contiguous(),
                                           right=True), 1, n - 1)
        lo, hi = asc[k - 1], asc[k]
        up = (k - 1) + (phi - lo) / (hi - lo)           # ascending index
        return torch.clamp((n - 1) - up, 0.0, float(n - 1))

    def interpolate(self, field, x, y):
        """Bilinear value of ``field`` (..., nz, nlat, nlon) at fractional
        longitude index ``x`` (periodic) and row ``y``, both (nz, nlat,
        nlon)."""
        nz, nlat, nlon = x.shape
        i0 = torch.floor(x).long()
        fx = (x - i0).to(field.dtype)
        i0 = torch.remainder(i0, nlon)
        i1 = torch.remainder(i0 + 1, nlon)
        j0 = torch.clamp(torch.floor(y).long(), 0, nlat - 2)
        fy = torch.clamp(y - j0, 0.0, 1.0).to(field.dtype)
        j1 = j0 + 1
        k = torch.arange(nz, device=x.device)[:, None, None]
        north = (field[..., k, j0, i0] * (1.0 - fx)
                 + field[..., k, j0, i1] * fx)
        south = (field[..., k, j1, i0] * (1.0 - fx)
                 + field[..., k, j1, i1] * fx)
        return north * (1.0 - fy) + south * fy

    def departure(self, u, v, dt):
        """Fractional (longitude index, row) of every arrival point's
        departure point over ``dt``."""
        lam_a = torch.broadcast_to(
            torch.arange(self.nlon, dtype=self.dtype, device=u.device)
            * self.dlam, u.shape)
        phi_a = torch.broadcast_to(self.phi[:, None], u.shape)
        u_m, v_m = u, v
        phi_d = phi_a
        for it in range(self.n_iter):
            if it:
                # the wind at the previous pass's trajectory midpoint
                x_m = (lam_a - 0.5 * dlam_d) / self.dlam
                y_m = self.row_of(torch.clamp(phi_a - 0.5 * dphi_d,
                                              self.phi_south,
                                              self.phi_north))
                u_m = self.interpolate(u, x_m, y_m)
                v_m = self.interpolate(v, x_m, y_m)
            cos_m = torch.clamp(torch.cos(0.5 * (phi_a + phi_d)),
                                min=COS_FLOOR)
            dlam_d = u_m * dt / (self.radius * cos_m)
            dphi_d = v_m * dt / self.radius
            phi_d = torch.clamp(phi_a - dphi_d, self.phi_south,
                                self.phi_north)
        return (lam_a - dlam_d) / self.dlam, self.row_of(phi_d)

    def advect(self, q, dp, u, v, mdot, dt):
        """One transport step over ``dt``: q (..., nz, nlat, nlon); dp, u,
        v (nz, nlat, nlon); mdot (nz-1, nlat, nlon).  Returns the
        transported mixing ratio."""
        x, y = self.departure(u, v, dt)
        return vertical_upwind(self.interpolate(q, x, y), dp, mdot, dt)[0]
