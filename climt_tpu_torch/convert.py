"""Carry a model's state between the JAX package and this port.

The carry of both ``build_moist_gcm`` models is ``(prev, now, grids, aux,
k)``: ``prev``/``now`` dicts of complex spectral fields (nz or 1 leading
levels, (M+1, N+1) trailing; with ``moisture_advection='fv'`` or
``'sl'`` their ``'q'`` is a real grid field), ``grids`` and ``aux`` dicts
of real grid fields, ``k`` the step index.  The carry of both
``build_held_suarez_model`` models is ``(prev, now, prev_grids)``, dicts
of the same kinds.  A JAX carry fetched with ``np.asarray`` on every leaf
(a tuple of dicts of numpy arrays, and the step index) converts to the
port's carry and back.  The models have no trainable weights; their
tables come from the same files in both packages.
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
    """A carry of numpy arrays -> the port's carry: each dict's arrays
    become tensors, a step index a Python int."""
    return tuple({name: _to_tensor(v, device, dtype)
                  for name, v in part.items()} if isinstance(part, dict)
                 else int(np.asarray(part)) for part in carry_np)


def carry_to_numpy(carry):
    """The port's carry -> the same tuple of dicts of numpy arrays, with a
    step index as an int32."""
    return tuple({name: v.detach().cpu().numpy()
                  for name, v in part.items()} if isinstance(part, dict)
                 else np.int32(part) for part in carry)
