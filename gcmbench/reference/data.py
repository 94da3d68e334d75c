"""Where the plain reference reads its RRTMG tables and ozone profile:
the files under ``climt_tpu/data/`` of the checkout, read with numpy by
path, never by importing a package."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'climt_tpu', 'data')

LW_SUPPORT = 'rrtmg_lw_support.npz'
LW_KDIST = 'rrtmg_lw_kdist_surrogate.npz'
LW_KDIST_AER = 'rrtmg_lw_kdist_aer.npz'
SW_KDIST = 'rrtmg_sw_kdist.npz'
OZONE = 'ozone_profile.npy'


@functools.lru_cache()
def load_numpy(name):
    """Raw float64 numpy contents of one data file (dict for an npz)."""
    if name.endswith('.npz'):
        return load_npz(name)
    return np.load(os.path.join(DATA_DIR, name))


def load_npz(path):
    """Contents of an npz as a dict of numpy arrays."""
    with np.load(os.path.join(DATA_DIR, path)) as f:
        return {k: f[k] for k in f.files}


_TENSOR_CACHE = {}


def load_tensors(name, dtype, device):
    """Contents of an npz as tensors of ``dtype`` on ``device`` (cached)."""
    key = (name, dtype, str(torch.device(device)))
    if key not in _TENSOR_CACHE:
        _TENSOR_CACHE[key] = {
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in load_numpy(name).items()}
    return _TENSOR_CACHE[key]
