"""Carry the moist GCM's state between the JAX model and this port.

The carry of both ``build_moist_gcm`` models is ``(prev, now, grids, aux,
k)``: ``prev``/``now`` dicts of complex spectral fields (nz or 1 leading
levels, (M+1, N+1) trailing), ``grids`` and ``aux`` dicts of real grid
fields, ``k`` the step index.  The JAX carry fetched with ``np.asarray``
on every leaf (a nested tuple of dicts of numpy arrays) converts to the
port's carry and back.  The model has no trainable weights; its tables
come from the same files in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.sht import complex_dtype


def _to_tensor(x, device, dtype):
    x = np.asarray(x)
    dt = complex_dtype(dtype) if np.iscomplexobj(x) else dtype
    return torch.as_tensor(np.array(x), dtype=dt, device=device)


def carry_from_numpy(carry_np, device, dtype):
    """(prev, now, grids, aux, k) of numpy arrays -> the port's carry."""
    prev, now, grids, aux, k = carry_np
    dicts = tuple({name: _to_tensor(v, device, dtype)
                   for name, v in d.items()}
                  for d in (prev, now, grids, aux))
    return dicts + (int(np.asarray(k)),)


def carry_to_numpy(carry):
    """The port's carry -> (prev, now, grids, aux, k) of numpy arrays."""
    prev, now, grids, aux, k = carry
    dicts = tuple({name: v.detach().cpu().numpy() for name, v in d.items()}
                  for d in (prev, now, grids, aux))
    return dicts + (np.int32(k),)
