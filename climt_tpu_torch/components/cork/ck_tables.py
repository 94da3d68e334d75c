"""Correlated-k table loading and vectorized optical-depth evaluation
(climt_tpu/components/cork/ck_tables.py).

Every (level, column) point is bracketed once on the table's (T, log p
[, log X_H2O[, log X_CO2]]) axes, and the 2^d corners of the multilinear
interpolation are gathered from the flattened table with ``index_select``
and accumulated in place, one corner at a time: at T85 with the Earth
table one corner is a (112, 917504) float64 block of 822 MB, so the
corners are never stacked.  CO2 is interpolated in log-k between its two
bracketing nodes, as the JAX module does.

The shipped tables are the JAX package's own files under
``climt_tpu/data/cork/correlated_k/``, read by path (``data.DATA_DIR``)
into plain numpy dicts, as the JAX loaders read them.  A table reaches a
device through ``table_tensors``, which casts it to the working dtype;
JAX reads that dtype from ``jax_enable_x64``, the port from its caller.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ... import data
from .common import bracket

_DATA = os.path.join(data.DATA_DIR, 'cork', 'correlated_k')

_NETCDF_VARS = (
    'k_coefficients', 'gpoint_weights', 'temperature_grid',
    'pressure_grid_log', 'h2o_vmr_grid', 'co2_vmr_grid',
    'band_wavenumber_limits', 'planck_fraction',
    'solar_source_per_gpoint', 'rayleigh_coefficient', 'continuum_kappa',
)

# CO2 runtime-axis interpolation: geometric (log-k) by design -- the
# band-mean k is convex/saturating in amount, so linear-in-value over
# log-spaced nodes over-estimates it (ck_tables.py:38)
CO2_INTERP_LOGK = True
# the floors of ck_tables.py:161,235-258
K_FLOOR = 1e-40
VMR_FLOOR = 1e-30


def _decode(x):
    if isinstance(x, bytes):
        return x.decode('utf-8')
    if isinstance(x, np.ndarray) and x.dtype.kind == 'S':
        return x.tobytes().decode('utf-8').rstrip('\x00')
    return str(x)


def _load_netcdf_table(path):
    """A table from a netCDF file: the variables of ``_NETCDF_VARS`` in
    native byte order, ``gas_names`` from a variable or a comma-separated
    attribute, and the string attributes (ck_tables.py:49-80)."""
    from scipy.io import netcdf_file
    out = {}
    with netcdf_file(path, 'r', mmap=False) as nc:
        for name in _NETCDF_VARS:
            if name in nc.variables:
                arr = np.asarray(nc.variables[name][:]).copy()
                if arr.dtype.byteorder not in ('=', '|'):
                    arr = arr.astype(arr.dtype.newbyteorder('='))
                out[name] = arr
        if 'gas_names' in nc.variables:
            raw = nc.variables['gas_names'][:]
            out['gas_names'] = np.asarray(
                [_decode(x) for x in np.atleast_1d(raw)])
        else:
            gn = getattr(nc, 'gas_names', None)
            if gn is not None:
                out['gas_names'] = np.asarray(
                    [s.strip() for s in _decode(gn).split(',')
                     if s.strip()])
        for attr in ('overlap_method', 'resolution',
                     'background_is_premixed'):
            val = getattr(nc, attr, None)
            if val is not None:
                out[attr] = np.asarray(_decode(val))
    return out


def _load_npz_table(path):
    with np.load(path, allow_pickle=True) as npz:
        return {name: npz[name] for name in npz.files}


@functools.lru_cache(maxsize=16)
def _load_named(name):
    for ext, loader in (('.npz', _load_npz_table),
                        ('.nc', _load_netcdf_table)):
        p = os.path.join(_DATA, name + ext)
        if os.path.isfile(p):
            return loader(p)
    raise FileNotFoundError(
        'No k-table named {!r} (.npz or .nc)'.format(name))


def load_k_table(name_or_path):
    """Load a correlated-k table into a plain dict of numpy arrays (a name
    resolves the shipped tables, preferring .npz; a path loads directly;
    a dict passes through)."""
    if isinstance(name_or_path, dict):
        return name_or_path
    if os.path.isfile(name_or_path):
        if name_or_path.endswith('.nc'):
            return _load_netcdf_table(name_or_path)
        return _load_npz_table(name_or_path)
    return dict(_load_named(name_or_path))


def table_tensors(table, dtype, device):
    """The parts of a k-table that the optical depth reads, as tensors of
    ``dtype`` on ``device``: ``k``, the temperature and log-pressure grids,
    the log H2O and CO2 grids with their clip bounds, and the log
    continuum.  The logs are taken in float64 numpy before the cast, as
    the JAX module takes them (ck_tables.py:240-268)."""
    def t(x):
        return torch.as_tensor(np.asarray(x, float), dtype=dtype,
                               device=device)

    k = np.asarray(table['k_coefficients'])
    out = {'k': t(k), 'T_grid': t(table['temperature_grid']),
           'p_grid_log': t(table['pressure_grid_log'])}
    for axis, key in (('x', 'h2o_vmr_grid'), ('c', 'co2_vmr_grid')):
        if k.ndim >= (6 if axis == 'x' else 7):
            grid = np.asarray(table[key], float)
            out['log_%s_grid' % axis] = t(np.log(np.maximum(grid,
                                                            VMR_FLOOR)))
            out['%s_range' % axis] = (float(grid[0]), float(grid[-1]))
    if ('continuum_kappa' in table
            and np.asarray(table['continuum_kappa']).ndim == 4):
        out['log_cont'] = t(np.log(np.maximum(
            np.asarray(table['continuum_kappa'], float), K_FLOOR)))
    return out


def interpolate_k_grid(k, T_grid, p_grid_log, log_x_grid, log_c_grid,
                       T, log_p, log_x, log_c, co2_logk):
    """Vectorized multilinear k interpolation at flattened points.

    k: (ngas, nband, ngpt, nT, nP[, nX[, nC]]); point tensors (npts,).
    Returns (ngas, nband, ngpt, npts)."""
    has_x = k.dim() >= 6
    has_c = k.dim() == 7
    shape = k.shape
    G = shape[0] * shape[1] * shape[2]
    grids = shape[3:]

    iT, fT = bracket(T_grid, T)
    iP, fP = bracket(p_grid_log, log_p)
    idxs = [iT, iP]
    fracs = [fT, fP]
    if has_x:
        iX, fX = bracket(log_x_grid, log_x)
        idxs.append(iX)
        fracs.append(fX)
    if has_c:
        iC, fC = bracket(log_c_grid, log_c)

    k2 = k.reshape(G, -1)
    strides = []
    s = 1
    for dim in reversed(grids):
        strides.append(s)
        s *= dim
    strides = strides[::-1]

    # multilinear over the bracketed axes excluding CO2 (handled in log-k
    # space below)
    naxes = len(idxs)

    def interp_at(c_off):
        acc = None
        for corner in range(2 ** naxes):
            offs = [(corner >> a) & 1 for a in range(naxes)]
            w = torch.ones_like(fracs[0])
            for a in range(naxes):
                w = w * (fracs[a] if offs[a] else (1.0 - fracs[a]))
            flat = torch.zeros_like(idxs[0])
            for i, off, st in zip(idxs, offs, strides):
                flat = flat + (i + off) * st
            if has_c:
                flat = flat + (iC + c_off) * strides[-1]
            term = k2.index_select(1, flat)
            if acc is None:
                acc = term.mul_(w)
            else:
                acc.addcmul_(term, w)
            del term
        return acc

    out = interp_at(0)
    if has_c:
        c1 = interp_at(1)
        if co2_logk:
            out.clamp_(min=K_FLOOR).log_().mul_(1.0 - fC)
            c1.clamp_(min=K_FLOOR).log_().mul_(fC)
            out.add_(c1).exp_()
        else:
            out.mul_(1.0 - fC).addcmul_(c1, fC)
        del c1
    return out.reshape(shape[0], shape[1], shape[2], -1)


def interpolate_continuum_grid(log_cont, T_grid, p_grid_log, log_x_grid,
                               T, log_p, log_x):
    """Band-grey H2O continuum, log-linear in value over (T, logp, logX)
    -- exact for any power law in X (ck_tables.py:181).
    log_cont: (nband, nT, nP, nX); returns (nband, npts)."""
    iT, fT = bracket(T_grid, T)
    iP, fP = bracket(p_grid_log, log_p)
    iX, fX = bracket(log_x_grid, log_x)
    nband = log_cont.shape[0]
    c2 = log_cont.reshape(nband, -1)
    nT, nP, nX = log_cont.shape[1:]

    def at(dT, dP, dX):
        flat = ((iT + dT) * nP + (iP + dP)) * nX + (iX + dX)
        return c2.index_select(1, flat)

    x0 = (at(0, 0, 0) * ((1 - fT) * (1 - fP))[None]
          + at(1, 0, 0) * (fT * (1 - fP))[None]
          + at(0, 1, 0) * ((1 - fT) * fP)[None]
          + at(1, 1, 0) * (fT * fP)[None])
    x1 = (at(0, 0, 1) * ((1 - fT) * (1 - fP))[None]
          + at(1, 0, 1) * (fT * (1 - fP))[None]
          + at(0, 1, 1) * ((1 - fT) * fP)[None]
          + at(1, 1, 1) * (fT * fP)[None])
    return torch.exp(x0 * (1 - fX)[None] + x1 * fX[None])


def compute_esft_weights(gpoint_weights, ngas):
    """ESFT combined g-point weights: outer product across gases (float64
    numpy, ck_tables.py:208)."""
    nband, ngpt = gpoint_weights.shape
    combined = np.zeros((nband, ngpt ** ngas))
    for b in range(nband):
        w = gpoint_weights[b]
        for idx in range(ngpt ** ngas):
            weight, rem = 1.0, idx
            for _ in range(ngas):
                weight *= w[rem % ngpt]
                rem //= ngpt
            combined[b, idx] = weight
    return combined


def overlap_method(table):
    """'additive' (the default) or 'esft': how a table's gases overlap."""
    return str(table.get('overlap_method', np.array('additive')))


def compute_ck_optical_depth(table, T, p, gas_amounts, h2o_vmr=None,
                             co2_vmr=None, dtype=None, tensors=None):
    """Optical depths from a correlated-k table (additive or ESFT).

    T, p and each gas's column amount are (nlev, ncol) tensors
    (``gas_amounts`` (ngas, nlev, ncol)); returns tau (nband, ngpt[^ngas],
    nlev, ncol) [and the float64 numpy g-point weights for ESFT].  The
    work runs in ``dtype`` (default T's) on T's device; ``tensors`` is the
    table's ``table_tensors`` there, if the caller holds them."""
    dtype = T.dtype if dtype is None else dtype
    if tensors is None:
        tensors = table_tensors(table, dtype, T.device)
    k = tensors['k']
    T_grid, p_grid_log = tensors['T_grid'], tensors['p_grid_log']
    has_x = k.dim() >= 6
    has_c = k.dim() == 7
    nlev, ncol = T.shape
    npts = nlev * ncol

    log_p = torch.log(torch.clamp(p, min=1.0)).reshape(npts)
    Tf = T.reshape(npts)
    log_x = log_c = None
    if has_x:
        if h2o_vmr is None:
            raise ValueError('k-table has an h2o_vmr_grid axis but '
                             'h2o_vmr was not provided')
        xc = torch.clamp(h2o_vmr, *tensors['x_range'])
        log_x = torch.log(torch.clamp(xc, min=VMR_FLOOR)).reshape(npts)
    if has_c:
        if co2_vmr is None:
            raise ValueError('k-table has a co2_vmr_grid axis but '
                             'co2_vmr was not provided')
        cc = torch.clamp(co2_vmr, *tensors['c_range'])
        log_c = torch.log(torch.clamp(cc, min=VMR_FLOOR)).reshape(npts)

    k_interp = interpolate_k_grid(
        k, T_grid, p_grid_log, tensors.get('log_x_grid'),
        tensors.get('log_c_grid'), Tf, log_p, log_x, log_c,
        CO2_INTERP_LOGK)
    ngas, nband, ngpt = k_interp.shape[:3]
    k_interp = k_interp.reshape(ngas, nband, ngpt, nlev, ncol)

    cont = None
    if 'log_cont' in tensors and h2o_vmr is not None:
        cont = interpolate_continuum_grid(
            tensors['log_cont'], T_grid, p_grid_log,
            tensors.get('log_x_grid'), Tf, log_p,
            log_x).reshape(nband, nlev, ncol)

    if overlap_method(table) == 'esft' and ngas > 1:
        combined_weights = compute_esft_weights(
            np.asarray(table['gpoint_weights']), ngas)
        ngpt_c = ngpt ** ngas
        # tau[b, idx] = sum_g k[g, b, g_idx(g, idx)] * amount[g]
        tau = torch.empty((nband, ngpt_c, nlev, ncol), dtype=k_interp.dtype,
                          device=k_interp.device)
        for idx in range(ngpt_c):
            rem = idx
            acc = 0.0
            for ig in range(ngas):
                g_idx = rem % ngpt
                rem //= ngpt
                acc = acc + k_interp[ig, :, g_idx] * gas_amounts[ig]
            tau[:, idx] = acc
        return tau, combined_weights

    # einsum('gbplc,glc->bplc') over the gases, in place
    tau = k_interp[0].mul_(gas_amounts[0])
    for ig in range(1, ngas):
        tau.addcmul_(k_interp[ig], gas_amounts[ig])
    del k_interp
    if cont is not None:
        tau.add_((cont * gas_amounts[0])[:, None, :, :])
    return tau
