"""The one place that knows where the data files live.

The RRTMG tables, the ozone profile, the Berger orbital tables and the
geographic netCDF files (land mask, topography, SST climatology) are the
JAX package's own files under ``climt_tpu/data/``, read with numpy or
scipy by path (importing ``climt_tpu`` would import jax).  No binary is
copied.  Every table handed to torch code is cast to the working dtype on
load: a stray float64 tensor would silently promote a float32 run to
float64.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'climt_tpu', 'data')

LW_SUPPORT = 'rrtmg_lw_support.npz'
LW_KDIST = 'rrtmg_lw_kdist_surrogate.npz'
# the real AER LW k-tables, where a user drops them in (the JAX package
# reads the same file, climt_tpu/components/rrtmg/lw_spectral.py:174)
LW_KDIST_AER = 'rrtmg_lw_kdist_aer.npz'
SW_KDIST = 'rrtmg_sw_kdist.npz'
OZONE = 'ozone_profile.npy'
BERGER = 'berger_orbital_tables.npz'
LAND_MASK = os.path.join('land_mask', 'earth_landmask_2deg.nc')
TOPOGRAPHY = os.path.join('topography', 'earth_topography_2deg.nc')
SST = os.path.join('data_ocean', 'earth_sst_climatology_1deg.nc')


@functools.lru_cache()
def load_numpy(name):
    """Raw float64 numpy contents of one data file (dict for an npz),
    cached by name."""
    if name.endswith('.npz'):
        return load_npz(name)
    return np.load(os.path.join(DATA_DIR, name))


def load_npz(path):
    """Raw contents of an npz as a dict of numpy arrays, read from
    ``path`` (absolute, or relative to the data directory) on every call:
    a file rewritten at the same path gives the new arrays.  A missing
    file or one that is not an npz archive raises."""
    f = np.load(os.path.join(DATA_DIR, path))
    if not hasattr(f, 'files'):
        raise ValueError('%s is not an npz archive' % path)
    with f:
        return {k: f[k] for k in f.files}


@functools.lru_cache()
def load_netcdf(name):
    """{variable: numpy array} of a netCDF file, with '__units__' mapping
    each variable to its units string (climt_tpu/components/geodata.py:46
    reads the same way).  ``name`` is relative to the data directory or an
    absolute path.  Cached: callers must not modify the arrays."""
    from scipy.io import netcdf_file
    out = {}
    units = {}
    with netcdf_file(os.path.join(DATA_DIR, name), 'r', mmap=False) as f:
        for key, var in f.variables.items():
            out[key] = np.array(var.data)
            u = getattr(var, 'units', b'')
            units[key] = u.decode() if isinstance(u, bytes) else u
    out['__units__'] = units
    return out


_TENSOR_CACHE = {}


def load_tensors(name, dtype, device):
    """Contents of an npz as tensors of ``dtype`` on ``device`` (cached)."""
    key = (name, dtype, str(torch.device(device)))
    if key not in _TENSOR_CACHE:
        _TENSOR_CACHE[key] = {
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in load_numpy(name).items()}
    return _TENSOR_CACHE[key]
