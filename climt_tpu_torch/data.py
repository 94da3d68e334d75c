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
SW_KDIST = 'rrtmg_sw_kdist.npz'
OZONE = 'ozone_profile.npy'
BERGER = 'berger_orbital_tables.npz'
LAND_MASK = os.path.join('land_mask', 'earth_landmask_2deg.nc')
TOPOGRAPHY = os.path.join('topography', 'earth_topography_2deg.nc')
SST = os.path.join('data_ocean', 'earth_sst_climatology_1deg.nc')


@functools.lru_cache()
def load_numpy(name):
    """Raw float64 numpy contents of one data file (dict for an npz)."""
    path = os.path.join(DATA_DIR, name)
    if name.endswith('.npz'):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    return np.load(path)


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
