"""Core numerical utilities on tensors (climt_tpu/core/util.py).

``jax_version_of`` (util.py:31) is ``torch_version_of`` here: it gives the
state's values as tensors on a device.  ``calculate_q_sat`` takes numpy
arrays or tensors, as the JAX one takes numpy or jax arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .dataarray import DataArray, as_tensor, to_numpy


def resolve_device(device='cuda'):
    """The torch.device of a constructor's ``device`` argument.  The
    default is the CUDA card; without one this raises rather than fall
    back to the CPU, which a caller asks for as ``device='cpu'``."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'device %r: no CUDA device is available '
            '(torch.cuda.is_available() is False); pass device="cpu" to '
            'run on the CPU' % str(dev))
    return dev


def area_mask(area_type, kinds, device):
    """Boolean tensor on ``device`` of the cells whose ``area_type`` is one
    of ``kinds``.  ``area_type`` is a numpy string array, never a tensor:
    the mask is made on the host, as the JAX components make theirs."""
    return torch.as_tensor(np.isin(area_type.astype(str), kinds),
                           device=device)


def numpy_version_of(state):
    """Strip DataArrays (and tensors on any device) down to host numpy
    arrays (util.py:20)."""
    raw = {}
    for name, value in state.items():
        if isinstance(value, DataArray):
            raw[name] = to_numpy(value.values)
        elif hasattr(value, 'shape'):
            raw[name] = to_numpy(value)
    return raw


def torch_version_of(state, device):
    """Tensors on ``device`` of a state's values (util.py:31's
    ``jax_version_of``)."""
    device = resolve_device(device)
    raw = {}
    for name, value in state.items():
        if isinstance(value, DataArray):
            value = value.values
        elif not hasattr(value, 'shape'):
            continue
        raw[name] = as_tensor(value, device)
    return raw


def mass_to_volume_mixing_ratio(
        mass_mixing_ratio, molecular_weight=None,
        molecular_weight_air=28.964):
    """Convert g/g mass mixing ratio to mole/mole volume mixing ratio
    (util.py:42)."""
    if molecular_weight is None:
        raise ValueError('The molecular weight must be provided')
    return mass_mixing_ratio * molecular_weight_air / molecular_weight


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


def calculate_q_sat(surface_temperature, surface_pressure, Rd, Rv):
    """Saturation specific humidity with distinct saturation-vapor-pressure
    fits above and below freezing (util.py:69)."""
    tensor = isinstance(surface_temperature, torch.Tensor)
    exp = torch.exp if tensor else np.exp
    where = torch.where if tensor else np.where
    T = surface_temperature
    p = surface_pressure
    es_warm = (1.0007 + 3.46e-8 * p) * 611.21 * exp(
        17.966 * (T - 273.) / (247.15 + (T - 273.)))
    es_cold = (1.0003 + 4.18e-8 * p) * 611.15 * exp(
        22.452 * (T - 273.) / (272.5 + (T - 273.)))
    es = where(T > 273., es_warm, es_cold)
    eps = Rd / Rv
    return eps * es / (p - (1 - eps) * es)


def bolton_dqsat_dT(T, Lv, Rh2O, q_sat):
    """d(q_sat)/dT under the Clausius-Clapeyron approximation of Reed &
    Jablonowski (2012), eq. 12 (util.py:92)."""
    return Lv * q_sat / (Rh2O * T ** 2)
