"""Surrogate k-distribution tables for the RRTMG-LW pipeline
(climt_tpu/components/rrtmg/lw_surrogate.py).

The tables are built from a flat parameter vector theta: per (band,
region, species) a log-quadratic in the probit of the cumulative g-point
weight (logk, s1, s2, alpha, beta and per-g deviations), per continuum
and minor gas (logk, s1, beta), and a Planck-fraction tilt per band; the
layout is the one ``lw_spectral.load_aer_tables`` reads (114 arrays for
the 16 bands).  ``build_tables`` is written in torch on theta's device
and dtype, so autograd follows it: the calibration
(``climt_tpu_torch.tools.calibrate_lw_ktables``) differentiates a loss of
the LW fluxes through the tables back to theta, as the JAX package does
with ``jax.value_and_grad``.  The host-side constants (the g-point
probits, the pressure and temperature grids of the tables, the
key-species ratios) stay numpy, as in JAX.

``build_tables(load_calibrated_params())`` is the shipped
``climt_tpu/data/rrtmg_lw_kdist_surrogate.npz``.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch
from scipy.special import ndtri

from ... import data
from .lw_spectral import BANDS_LW, CHI_ROW, NG, load_support

_PARAMS_JSON = os.path.join(data.DATA_DIR, 'rrtmg_lw_surrogate_params.json')

# per-band minor-gas table names used by lw_spectral.taumol_lw
_MINOR_TABLE = {'lo': 'ka_m%s', 'up': 'kb_m%s'}
# rough LW cross-sections for the halocarbons (cm^2/molec * 1e20); the
# cache states have zero halocarbon so these are physical placeholders
_CFC_XS = {'ccl4': 10.0, 'cfc11adj': 12.0, 'cfc12': 12.0, 'cfc22adj': 10.0}


@functools.lru_cache()
def gpoint_positions():
    """Per-band probit positions x_g of the reduced g-points, and the
    combined quadrature weight per reduced g-point (numpy)."""
    t = load_support()
    wt, ngn = t['wt'], t['ngn'].astype(int)
    xs, ws = [], []
    ipr = 0
    for bi, ng in enumerate(NG):
        w = np.zeros(ng)
        for ig in range(ng):
            for _ in range(ngn[sum(NG[:bi]) + ig]):
                w[ig] += wt[ipr % 16]
                ipr += 1
        w = w / w.sum()
        c = np.cumsum(w) - 0.5 * w                  # cumulative midpoints
        xs.append(ndtri(c))
        ws.append(w)
    return xs, ws


def _species_list(spec):
    if spec is None:
        return []
    return list(spec[:2]) if len(spec) == 3 else [spec[0]]


def param_layout():
    """Ordered list of (key, n_params) defining the flat parameter vector.

    Keys: 'b{n}_{lo|up}_{species}' -> 5 + ng params (logk, s1, s2, alpha,
          beta, per-g log-k deviations)
          'b{n}_self' / 'b{n}_for' -> 3 params (logk, s1, beta)
          'b{n}_{lo|up}_m_{gas}'   -> 3 params (logk, s1, beta)
          'b{n}_fraca' / 'b{n}_fracb' -> 2 params (Planck-fraction tilt)
    """
    layout = []
    for bi, bd in enumerate(BANDS_LW):
        num = bd['num']
        ng = NG[bi]
        for region in ('lo', 'up'):
            for sp in _species_list(bd.get(region)):
                layout.append(('b%d_%s_%s' % (num, region, sp), 5 + ng))
        if bd.get('self_lo'):
            layout.append(('b%d_self' % num, 3))
        if bd.get('for_lo') or bd.get('for_up'):
            layout.append(('b%d_for' % num, 3))
        for region in ('lo', 'up'):
            for gas, _mode in bd.get('minors_' + region, ()):
                layout.append(('b%d_%s_m_%s' % (num, region, gas), 3))
        # f_g ~ w_g exp(c1 x + c2 x^2)
        layout.append(('b%d_fraca' % num, 2))
        if bd.get('up') is not None:
            layout.append(('b%d_fracb' % num, 2))
    return layout


# Physically-motivated initial strengths, ln k per (1e-20 molec/cm^2),
# as in the JAX module: H2O strong below 500 cm-1, weak in the window;
# CO2 at 667 and 2350 cm-1; O3 at 9.6 um.
_H2O_LOGK = {1: 0.5, 2: -1.0, 3: -3.0, 4: -5.0, 5: -6.5, 6: -8.0,
             7: -8.5, 8: -8.5, 9: -6.5, 10: -4.0, 11: -5.0, 12: -6.0,
             13: -6.5, 14: -8.0, 15: -8.0, 16: -7.0}
_CO2_LOGK = {3: -1.5, 4: 0.0, 5: -1.0, 12: -4.0, 14: 0.5, 15: -3.0}
_O3_LOGK = {4: -1.0, 5: -0.5, 7: 1.0, 8: -2.0}
_CH4_LOGK = {9: -2.0, 16: -2.5}
_N2O_LOGK = {3: -2.0, 9: -1.5, 13: -2.0, 15: -2.0}
_SPECIES_LOGK = dict(h2o=_H2O_LOGK, co2=_CO2_LOGK, o3=_O3_LOGK,
                     ch4=_CH4_LOGK, n2o=_N2O_LOGK)
_MINOR_LOGK = dict(n2=-26.0, co2=-6.0, o3=-4.0, n2o=-4.0, o2=-12.0,
                   co=-6.0)


def default_params():
    """Initial physical-prior parameter vector (numpy, float64)."""
    vals = []
    for key, n in param_layout():
        parts = key.split('_')
        num = int(parts[0][1:])
        if n >= 5 and parts[1] in ('lo', 'up') and '_m_' not in key:
            logk = _SPECIES_LOGK.get(parts[2], {}).get(num, -6.0)
            if parts[1] == 'up':
                logk -= 1.0
            vals.extend([logk, 2.5, -0.15, 0.7, 0.003])
            vals.extend([0.0] * (n - 5))            # per-g deviations
        elif 'fraca' in key or 'fracb' in key:
            vals.extend([0.0, 0.0])
        elif 'self' in key:
            vals.extend([-1.5, 2.0, -0.03])
        elif '_m_' in key:
            vals.extend([_MINOR_LOGK.get(parts[-1], -8.0), 1.5, 0.0])
        else:                                       # foreign continuum
            vals.extend([-3.5, 2.0, -0.002])
    return np.array(vals, np.float64)


def unpack_params(theta):
    """{key: slice of theta} in ``param_layout`` order."""
    out = {}
    pos = 0
    for key, n in param_layout():
        out[key] = theta[pos:pos + n]
        pos += n
    assert pos == (theta.shape[0] if hasattr(theta, 'shape')
                   else len(theta)), 'parameter vector size mismatch'
    return out


def _logk_surface(p5, x, logp, temp):
    """log k over (x_g, node) grids: logk + s1 x + s2 x^2 + delta_g +
    alpha dlnp + beta dT.  p5 a tensor (p5[5:] the per-g deviations), x
    (ng,) and the logp/temp node arrays tensors of p5's dtype and
    device."""
    logk, s1, s2, alpha, beta = p5[0], p5[1], p5[2], p5[3], p5[4]
    delta = p5[5:] if p5.shape[0] > 5 else 0.0
    return (logk + s1 * x + s2 * x * x + delta
            + alpha * (logp - np.log(250.0))[..., None]
            + beta * (temp - 250.0)[..., None])


def build_tables(theta):
    """The full surrogate k-table dict from the flat parameter vector:
    {name: tensor} in ``load_aer_tables``' layout, on theta's device and
    in its dtype (numpy becomes a float64 CPU tensor), differentiable in
    theta.  absa rows follow the Fortran index arithmetic
    ind = ((jp-1)*5 + (jt-1))*nspa + js (taumol.f90:318-319)."""
    if not torch.is_tensor(theta):
        theta = torch.as_tensor(np.asarray(theta, np.float64))
    dtype, device = theta.dtype, theta.device

    def const(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    t = load_support()
    params = unpack_params(theta)
    xs, ws = gpoint_positions()
    preflog = t['preflog']
    tref = t['tref']
    chi = t['chi_mls']

    # lower grid: jp = 1..13, 5 temperature nodes tref(jp) + 15*(jt-3)
    jp_lo = np.arange(13)
    logp_lo = const(np.repeat(preflog[jp_lo], 5))               # (65,)
    temp_lo = const((tref[jp_lo][:, None]
                     + 15.0 * (np.arange(5) - 2)[None]).reshape(-1))
    # upper grid: jp = 13..59 (47 nodes)
    jp_up = np.arange(12, 59)
    logp_up = const(np.repeat(preflog[jp_up], 5))               # (235,)
    temp_up = const((tref[jp_up][:, None]
                     + 15.0 * (np.arange(5) - 2)[None]).reshape(-1))

    # self/foreign/minor temperature grids (setcoef index formulas)
    dt_self = const(188.0 + 7.2 * (np.arange(1, 11) + 7) - 296.0)[:, None]
    dt_for = const(np.array([296.0, 260.0, 224.0, 260.0]) - 296.0)[:, None]
    dt_minor = const(180.8 + 7.2 * np.arange(1, 20) - 250.0)[:, None]

    out = {}
    for bi, bd in enumerate(BANDS_LW):
        num, ng = bd['num'], NG[bi]
        x = const(xs[bi])

        def key_table(region, logp, temp, jp_nodes, n_eta):
            spec = bd.get(region)
            if spec is None:
                return None
            sps = _species_list(spec)
            ks = [torch.exp(_logk_surface(
                params['b%d_%s_%s' % (num, region, sp)], x, logp, temp))
                for sp in sps]
            if len(sps) == 1:
                return ks[0]                        # (rows, ng)
            # eta mixing: table(eta_j) = eta k1 + (1-eta) k2 / rat(jp),
            # rat the chi ratio at the pressure node
            r1 = chi[CHI_ROW[sps[0]] - 1, jp_nodes]
            r2 = chi[CHI_ROW[sps[1]] - 1, jp_nodes]
            rat = const(np.repeat(r1 / r2, 5))      # (rows,)
            eta = const(np.arange(n_eta) / (n_eta - 1))
            k1, k2 = ks
            mix = (eta[None, :, None] * k1[:, None, :]
                   + (1.0 - eta)[None, :, None]
                   * (k2 / rat[:, None])[:, None, :])
            return mix.reshape(-1, ng)              # rows*n_eta, ng

        nspa = 9 if (bd.get('lo') and len(bd['lo']) == 3) else 1
        nspb = 5 if (bd.get('up') and len(bd['up']) == 3) else 1
        absa = key_table('lo', logp_lo, temp_lo, jp_lo, nspa)
        if absa is not None:
            out['b%d_absa' % num] = absa
        absb = key_table('up', logp_up, temp_up, jp_up, nspb)
        if absb is not None:
            out['b%d_absb' % num] = absb

        if bd.get('self_lo'):
            logk, s1, beta = params['b%d_self' % num]
            out['b%d_selfref' % num] = torch.exp(
                logk + s1 * x + beta * dt_self)
        if bd.get('for_lo') or bd.get('for_up'):
            logk, s1, beta = params['b%d_for' % num]
            out['b%d_forref' % num] = torch.exp(
                logk + s1 * x + beta * dt_for)

        for region in ('lo', 'up'):
            for gas, _mode in bd.get('minors_' + region, ()):
                logk, s1, beta = params['b%d_%s_m_%s' % (num, region, gas)]
                out[('b%d_' % num) + (_MINOR_TABLE[region] % gas)] = \
                    torch.exp(logk + s1 * x + beta * dt_minor)

        for region in ('lo', 'up'):
            for gas, tname in bd.get('wx_' + region, ()):
                key = 'b%d_%s' % (num, tname)
                if key not in out:
                    out[key] = torch.full((ng,), _CFC_XS[tname], dtype=dtype,
                                          device=device)

        w = const(ws[bi])
        c1, c2 = params['b%d_fraca' % num]
        fa = w * torch.exp(c1 * x + c2 * x * x)
        out['b%d_fracrefa' % num] = fa / torch.sum(fa)
        if bd.get('up') is not None:
            c1b, c2b = params['b%d_fracb' % num]
            fb = w * torch.exp(c1b * x + c2b * x * x)
            out['b%d_fracrefb' % num] = fb / torch.sum(fb)
    return out


def load_calibrated_params():
    """The calibrated parameter vector (numpy float64; the priors when the
    file is absent)."""
    if os.path.exists(_PARAMS_JSON):
        with open(_PARAMS_JSON) as f:
            return np.array(json.load(f)['theta'], np.float64)
    return default_params()


def save_params(theta, meta=None):
    """Write theta (numpy or a tensor) and ``meta`` to the parameter file
    that ``load_calibrated_params`` reads."""
    if torch.is_tensor(theta):
        theta = theta.detach().cpu().numpy()
    payload = {'theta': np.asarray(theta).tolist()}
    if meta:
        payload['meta'] = meta
    with open(_PARAMS_JSON, 'w') as f:
        json.dump(payload, f)
