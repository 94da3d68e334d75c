"""Shared CORK helpers: molar masses, column amounts, heating rates
(climt_tpu/components/cork/common.py)."""

from __future__ import annotations

import torch

MOLAR_MASS_DRY_AIR = 28.970        # g/mol
MOLAR_MASS = {
    'h2o': 18.015,
    'co2': 44.010,
    'o3': 47.998,
    'ch4': 16.043,
    'n2o': 44.013,
    'o2': 31.998,
}


def compute_column_amount(q, p_interface, g):
    """Per-layer column amount (kg/m^2) of a gas with mixing ratio q."""
    dp = torch.abs(p_interface[1:] - p_interface[:-1])
    return q * dp / g


def compute_heating_rate(net_flux, p_interface, g, cpd):
    """Heating rate (K/s) from the net (up minus down) flux divergence."""
    dp = p_interface[1:] - p_interface[:-1]
    dflux = net_flux[1:] - net_flux[:-1]
    return g / cpd * dflux / dp


def bracket(grid, v):
    """(index, fraction) for linear interpolation of v on an ascending
    grid, with the JAX module's clamps (index in [0, n-2], fraction in
    [0, 1]).  ``torch.searchsorted(right=False)`` is ``jnp.searchsorted``'s
    default side='left': a value on a node brackets from the node below
    (fraction 1), except on the first node."""
    n = grid.shape[0]
    i = torch.clamp(torch.searchsorted(grid, v, right=False) - 1, 0, n - 2)
    f = torch.clamp((v - grid[i]) / (grid[i + 1] - grid[i]), 0.0, 1.0)
    return i, f
