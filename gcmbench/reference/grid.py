"""Grid constants and column helpers of the plain reference: the
Gauss-Legendre nodes, the hybrid sigma-pressure coefficients, interface
values and the Bolton saturation humidity."""

from __future__ import annotations

import numpy as np
import torch


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


def get_interface_values(mid_level_values, surface_value,
                         mid_level_pressure, interface_level_pressure):
    """Linear-in-log-pressure interpolation of mid-level values (vertical
    axis first, length K) onto K+1 interfaces; the bottom interface takes
    the surface value, the top one the top mid-level value (util.py:51)."""
    log_p = torch.log(mid_level_pressure)
    weight = (torch.log(interface_level_pressure[1:-1]) - log_p[1:]) / (
        log_p[:-1] - log_p[1:])
    interior = mid_level_values[1:] - weight * (
        mid_level_values[1:] - mid_level_values[:-1])
    return torch.cat([surface_value[None], interior,
                      mid_level_values[-1:]], dim=0)


def bolton_q_sat(T, p, Rd, Rh2O):
    """Bolton (1980) saturation specific humidity (util.py:84)."""
    es = 611.2 * torch.exp(17.67 * (T - 273.15) / (T - 29.65))
    eps = Rd / Rh2O
    return eps * es / (p - (1 - eps) * es)
