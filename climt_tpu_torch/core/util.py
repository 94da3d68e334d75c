"""Core numerical utilities on tensors (climt_tpu/core/util.py)."""

from __future__ import annotations

import torch


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
