"""Grid construction (numpy, build-once), copied from climt_tpu.core.grid.

``gauss_legendre_nodes`` is climt_tpu/core/grid.py:28,
``gaussian_latitudes`` :54, ``_newhyb2_exponent`` :64,
``hybrid_sigma_pressure_coefficients`` :73, ``pressures_from_aks`` :121,
``HybridSigmaPressureDiagnosticComponent`` :138 and ``get_grid`` :188;
they are copied so this package never imports the JAX one.  The
diagnostic component also takes a surface pressure that lives in a tensor
(on any device) and then answers with tensors there.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

from .base_components import DiagnosticComponent
from .constants import get_constant, set_constant
from .dataarray import DataArray, common_backend


def gauss_legendre_nodes(n):
    """Gauss-Legendre nodes and weights on [-1, 1] (grid.py:28).

    Symmetric companion-matrix eigenvalues with one Newton refinement.
    """
    c = np.zeros(n + 1)
    c[-1] = 1.0
    m = np.polynomial.legendre.legcompanion(c)
    x = np.linalg.eigvalsh(m)
    val = np.polynomial.legendre.legval(x, c)
    deriv = np.polynomial.legendre.legval(
        x, np.polynomial.legendre.legder(c))
    x -= val / deriv
    deriv = np.polynomial.legendre.legval(
        x, np.polynomial.legendre.legder(c))
    w = 2.0 / ((1.0 - x ** 2) * deriv ** 2)
    w = (w + w[::-1]) / 2
    x = (x - x[::-1]) / 2
    w *= 2.0 / w.sum()
    return x, w


def gaussian_latitudes(n):
    """Gaussian latitudes (degrees, north->south) and cell edges
    (grid.py:54)."""
    x, weights = gauss_legendre_nodes(n)
    edges = np.empty(n + 1)
    edges[0] = -1.0
    edges[1:-1] = -1.0 + np.cumsum(weights[:-1])
    edges[-1] = 1.0
    return -np.rad2deg(np.arcsin(x)), -np.rad2deg(np.arcsin(edges))


def _newhyb2_exponent(b_half, num_sigma_levels):
    """Interpolating exponent r(b) of the NEWHYB2 coordinate (grid.py:64)."""
    r_pressure = 2.2
    r_sigma = 1.0 if num_sigma_levels > 0 else 1.35
    s = 5.0
    return r_pressure + (r_sigma - r_pressure) * (
        np.arctan(s * b_half) / np.arctan(s))


def hybrid_sigma_pressure_coefficients(
        num_interface_levels=29,
        reference_pressure=1e5,
        model_top_pressure=20.,
        proportion_isobaric_levels=0.25,
        proportion_sigma_levels=0.1):
    """Eckermann-2008 NEWHYB2 ak, bk, surface -> top (grid.py:73), with
    p_interface = ak + bk * (p_surface - p_top)."""
    n = num_interface_levels
    thickness = np.sin(np.linspace(0.1, np.pi - 0.1, n - 1))
    thickness *= (reference_pressure - model_top_pressure) / thickness.sum()

    p_interface = np.empty(n)
    p_interface[0] = model_top_pressure
    p_interface[1:] = model_top_pressure + np.cumsum(thickness)

    sigma = (p_interface - model_top_pressure) / (
        reference_pressure - model_top_pressure)

    ak = np.zeros(n)
    bk = np.zeros(n)
    n_isobaric = int(proportion_isobaric_levels * n)
    n_sigma = int(proportion_sigma_levels * n)

    ak[:n_isobaric] = p_interface[:n_isobaric]
    sigma_iso = sigma[n_isobaric - 1]

    for k in range(n_isobaric, n - n_sigma):
        b = (sigma[k] - sigma_iso) / (1.0 - sigma_iso)
        bk[k] = b ** _newhyb2_exponent(b, n_sigma)
        ak[k] = model_top_pressure + (sigma[k] - bk[k]) * (
            reference_pressure - model_top_pressure)
    for k in range(n - n_sigma, n):
        bk[k] = (sigma[k] - sigma_iso) / (1.0 - sigma_iso)
        ak[k] = model_top_pressure + (sigma[k] - bk[k]) * (
            reference_pressure - model_top_pressure)

    return ak[::-1].copy(), bk[::-1].copy()


def pressures_from_aks(ak, bk, p_surface, model_top_pressure, rd_over_cp):
    """Interface and mid-level pressures from hybrid coefficients
    (grid.py:121), with the energy-consistent mid-level formula
    p_mid = [ (p_{k+1}^(kappa+1) - p_k^(kappa+1)) / ((kappa+1) dp) ]^(1/kappa).
    Elementwise, so numpy arrays and tensors both work."""
    p_interface = ak[:, None] + bk[:, None] * (
        p_surface[None, :] - model_top_pressure)
    dp = p_interface[1:, :] - p_interface[:-1, :]
    rk = rd_over_cp
    p_mid = ((p_interface[1:, :] ** (rk + 1)
              - p_interface[:-1, :] ** (rk + 1))
             / ((rk + 1) * dp)) ** (1.0 / rk)
    return p_interface, p_mid


class HybridSigmaPressureDiagnosticComponent(DiagnosticComponent):
    """Diagnoses 3-D pressure fields from the hybrid coefficients and the
    surface pressure (grid.py:138)."""

    input_properties = {
        'atmosphere_hybrid_sigma_pressure_a_coordinate_on_interface_levels': {
            'units': 'dimensionless',
            'dims': ['interface_levels', '*'],
            'alias': 'a_coord',
        },
        'atmosphere_hybrid_sigma_pressure_b_coordinate_on_interface_levels': {
            'units': 'dimensionless',
            'dims': ['interface_levels', '*'],
            'alias': 'b_coord',
        },
        'surface_air_pressure': {
            'units': 'Pa',
            'dims': ['*'],
        },
    }

    diagnostic_properties = {
        'air_pressure': {
            'units': 'Pa',
            'dims': ['mid_levels', '*'],
        },
        'air_pressure_on_interface_levels': {
            'units': 'Pa',
            'dims': ['interface_levels', '*'],
        },
    }

    def array_call(self, state):
        p_top = get_constant('top_of_model_pressure', 'Pa')
        rd = get_constant('gas_constant_of_dry_air', 'J kg^-1 K^-1')
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J kg^-1 K^-1')
        a, b = state['a_coord'], state['b_coord']
        # a_coord rows are constant along '*'; take column 0 as the profile
        if a.ndim == 2:
            a, b = a[:, 0], b[:, 0]
        ps = state['surface_air_pressure'].reshape(-1)
        ps, a, b = common_backend(ps, a, b)
        p_interface, p_mid = pressures_from_aks(a, b, ps, p_top, rd / cpd)
        return {
            'air_pressure': p_mid,
            'air_pressure_on_interface_levels': p_interface,
        }


def get_grid(
        nx=None, ny=None, nz=28, n_ice_interface_levels=10,
        n_soil_interface_levels=4,
        p_surf_in_Pa=None, p_toa_in_Pa=None,
        proportion_sigma_levels=0.1,
        proportion_isobaric_levels=0.25,
        x_name='lon', y_name='lat',
        latitude_grid='gaussian'):
    """Build the grid state (grid.py:188): hybrid sigma-pressure
    coefficients, 3-D pressures, 2-D latitude/longitude, and the ice and
    soil vertical grids, all numpy-backed.  Longitudes are the even
    subdivision of [0, 360), latitudes Gaussian (or regular) midpoints,
    and a missing nx/ny produces a single column."""
    if p_surf_in_Pa is None:
        p_surf_in_Pa = get_constant('reference_air_pressure', 'Pa')
    if p_toa_in_Pa is None:
        p_toa_in_Pa = get_constant('top_of_model_pressure', 'Pa')
    else:
        set_constant('top_of_model_pressure', p_toa_in_Pa, 'Pa')

    nx = 1 if nx is None else nx
    ny = 1 if ny is None else ny

    ak, bk = hybrid_sigma_pressure_coefficients(
        nz + 1, p_surf_in_Pa, p_toa_in_Pa,
        proportion_isobaric_levels, proportion_sigma_levels)

    grid_state = {
        'atmosphere_hybrid_sigma_pressure_a_coordinate_on_interface_levels':
            DataArray(ak, dims=['interface_levels'],
                      attrs={'units': 'dimensionless'}),
        'atmosphere_hybrid_sigma_pressure_b_coordinate_on_interface_levels':
            DataArray(bk, dims=['interface_levels'],
                      attrs={'units': 'dimensionless'}),
        'surface_air_pressure': DataArray(
            np.full((ny, nx), p_surf_in_Pa),
            dims=[y_name, x_name], attrs={'units': 'Pa'}),
        'time': datetime(2000, 1, 1),
    }
    grid_state.update(
        HybridSigmaPressureDiagnosticComponent()(grid_state))

    lons2d = np.broadcast_to(
        np.linspace(0., 360., nx * 2, endpoint=False)[:-1:2][None, :],
        (ny, nx)).copy()
    grid_state['longitude'] = DataArray(
        lons2d, dims=[y_name, x_name], attrs={'units': 'degrees_east'})

    if latitude_grid.lower() == 'regular':
        lat = np.linspace(-90., 90., ny * 2 + 1, endpoint=True)[1:-1:2]
    elif latitude_grid.lower() == 'gaussian':
        lat, _ = gaussian_latitudes(ny)
    else:
        raise ValueError(
            "latitude_grid must be 'regular' or 'gaussian'")
    lats2d = np.broadcast_to(lat[:, None], (ny, nx)).copy()
    grid_state['latitude'] = DataArray(
        lats2d, dims=[y_name, x_name], attrs={'units': 'degrees_north'})

    if n_ice_interface_levels is not None:
        grid_state['height_on_ice_interface_levels'] = DataArray(
            np.zeros(n_ice_interface_levels),
            dims=['ice_interface_levels'], attrs={'units': 'm'})
    if n_soil_interface_levels is not None:
        grid_state['height_on_soil_interface_levels'] = DataArray(
            np.linspace(0.0, 2.0, n_soil_interface_levels),
            dims=['soil_interface_levels'], attrs={'units': 'm'})
    return grid_state
