"""Spherical horizontal differential operators on a lat/lon grid
(climt_tpu/ops/horizontal.py): centered differences in the interior,
one-sided at the edges (np.gradient's rule), the sphere's metric terms,
and zero where either dimension is too short to difference.
"""

from __future__ import annotations

import torch

from ..core.constants import get_constant


def _grads(field, lat, lon):
    """(d/dx, d/dy) of a (nlat, nlon) field on the sphere."""
    if field.shape[0] < 3 or field.shape[1] < 3:
        z = torch.zeros_like(field)
        return z, z
    a = get_constant('planetary_radius', 'm')
    latr = torch.deg2rad(lat)
    lonr = torch.deg2rad(lon)
    dfdlat = torch.gradient(field, dim=0)[0] / torch.gradient(latr, dim=0)[0]
    dfdlon = torch.gradient(field, dim=1)[0] / torch.gradient(lonr, dim=1)[0]
    return dfdlon / (a * torch.cos(latr)), dfdlat / a


def divergence(fx, fy, lat, lon):
    """d(fx)/dx + d(fy)/dy on the sphere; (nlat, nlon) tensors."""
    return _grads(fx, lat, lon)[0] + _grads(fy, lat, lon)[1]


def curl_z(fx, fy, lat, lon):
    """Vertical curl d(fy)/dx - d(fx)/dy on the sphere."""
    return _grads(fy, lat, lon)[0] - _grads(fx, lat, lon)[1]
