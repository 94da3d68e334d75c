"""Parmentier & Guillot (2014) picket-fence optics and the Freedman et al.
(2014) Rosseland-mean opacity fit (climt_tpu/components/cork/parmentier.py).

The JAX module evaluates these in numpy on the host from the state's
fields; here they are torch operations on the fields' own device, so a
call on the card copies no state field to the host.  The coefficient files
are the JAX package's own, read by path (``data.DATA_DIR``).  The two
stellar-spectrum helpers are host utilities off the component's call path
and stay numpy.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ... import data

_DATA = os.path.join(data.DATA_DIR, 'cork', 'parmentier')
_STELLAR = os.path.join(data.DATA_DIR, 'cork', 'stellar_spectra')


@functools.lru_cache(maxsize=4)
def load_freedman2014_coefficients():
    with np.load(os.path.join(_DATA, 'freedman2014.npz')) as npz:
        return {k: npz[k] for k in npz.files}


def load_parmentier_coefficients(name_or_path):
    path = (name_or_path if os.path.isfile(name_or_path)
            else os.path.join(_DATA, name_or_path + '.npz'))
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def compute_rosseland_mean_opacity(T, p, coeffs):
    """Freedman et al. (2014) fit, m^2/kg; T, p tensors of any shape,
    ``coeffs`` the scalars of ``load_freedman2014_coefficients``."""
    c = {k: float(v) for k, v in coeffs.items()}
    log_T = torch.log10(torch.clamp(T, min=10.0))
    log_P = torch.log10(torch.clamp(p * 10.0, min=1.0))
    lo = c['a_lo'] * log_T + c['b_lo'] * log_P + c['c_lo']
    hi = c['a_hi'] * log_T + c['b_hi'] * log_P + c['c_hi']
    log_k = torch.where(T < c['T_boundary'], lo, hi)
    return 10.0 ** log_k * 0.1


def compute_thermal_opacities(kappa_R, gamma_P, beta, R):
    """Two thermal band opacities (P&G 2014 Eqs 87-96)."""
    kappa_2 = kappa_R * (beta / R + 1.0 - beta)
    kappa_1 = R * kappa_2
    return kappa_1, kappa_2


def lookup_ratio_coefficients(coeffs, T_eff):
    """Parmentier ratio coefficients at T_eff (a tensor over columns).

    ``coeffs`` is a ``load_parmentier_coefficients`` dict; its per-region
    tables may already be tensors on T_eff's device.  Returns (gamma_v1,
    gamma_v2, gamma_v3, beta, gamma_P, R), each shaped like T_eff."""
    X = torch.log10(torch.clamp(T_eff, min=10.0))
    boundaries = [float(b) for b in np.asarray(coeffs['T_eff_boundaries'])]
    # region: the JAX module scans the intervals and leaves region 0 when
    # none matches (T_eff below the first boundary or at/above the last)
    region = torch.zeros(T_eff.shape, dtype=torch.int64, device=T_eff.device)
    matched = torch.zeros(T_eff.shape, dtype=torch.bool, device=T_eff.device)
    for i in range(len(boundaries) - 1):
        sel = (~matched & (T_eff >= boundaries[i])
               & (T_eff < boundaries[i + 1]))
        region = torch.where(sel, i, region)
        matched |= sel

    def lin(name):
        ab = torch.as_tensor(coeffs[name], dtype=T_eff.dtype,
                             device=T_eff.device)
        return ab[region, 0] + ab[region, 1] * X

    gamma_v1 = 10.0 ** lin('log10_gamma_v1_ab')
    gamma_v2 = 10.0 ** lin('log10_gamma_v2_ab')
    gamma_v3 = 10.0 ** lin('log10_gamma_v3_ab')
    beta = torch.clamp(lin('beta_ab'), 0.01, 0.99)
    q0, q1, q2 = (float(q) for q in np.asarray(coeffs['log10_gamma_P_quad']))
    gamma_P = torch.clamp(10.0 ** (q0 + q1 * X + q2 * X ** 2), min=1.0)

    gp1 = gamma_P - 1.0
    disc = gp1 ** 2 + 4.0 * beta * (1.0 - beta) * gp1
    denom = 2.0 * beta * (1.0 - beta)
    R = torch.where(disc < 0.0, 1.0, torch.clamp(
        1.0 + gp1 / denom + torch.sqrt(torch.clamp(disc, min=0.0)) / denom,
        min=1.0))
    return gamma_v1, gamma_v2, gamma_v3, beta, gamma_P, R


def bond_albedo_from_fluxes(up_toa, down_toa):
    """up/down at the top, 0 where nothing comes down, clipped to [0, 1]."""
    ratio = up_toa / torch.where(down_toa > 0, down_toa,
                                 torch.ones_like(down_toa))
    return torch.clamp(torch.where(down_toa > 0, ratio,
                                   torch.zeros_like(ratio)), 0.0, 1.0)


def load_stellar_spectrum(name_or_path):
    path = (name_or_path if os.path.isfile(name_or_path)
            else os.path.join(_STELLAR, name_or_path + '.npz'))
    with np.load(path) as npz:
        return {'wavenumber': np.array(npz['wavenumber']),
                'irradiance': np.array(npz['irradiance'])}


def integrate_spectrum_over_bands(spectrum, band_wavenumber_limits):
    """Trapezoid-integrate a stellar spectrum over wavenumber bands (float64
    numpy)."""
    wn = spectrum['wavenumber']
    irr = spectrum['irradiance']
    nband = band_wavenumber_limits.shape[0]
    flux = np.zeros(nband)
    for b in range(nband):
        wn_lo, wn_hi = band_wavenumber_limits[b]
        mask = (wn > wn_lo) & (wn < wn_hi)
        irr_lo = np.interp(wn_lo, wn, irr)
        irr_hi = np.interp(wn_hi, wn, irr)
        wn_band = np.concatenate(([wn_lo], wn[mask], [wn_hi]))
        irr_band = np.concatenate(([irr_lo], irr[mask], [irr_hi]))
        flux[b] = np.trapezoid(irr_band, wn_band)
    return flux
