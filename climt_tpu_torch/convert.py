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

A model built with ``mesh=`` carries each rank's blocks: the rows
``sht.rows`` of every grid field and the m-block ``sht.m_rows`` of every
spectral field, with M padded to ``sht.M_padded`` (``sht`` is the model's
``parallel.DistributedSHT``).  ``carry_to_rank`` cuts a rank's carry out
of a global numpy carry (the single-device layout, or JAX's mesh carry
fetched with ``np.asarray``, whose M is already padded), and
``carry_to_global`` gathers the ranks' carries back into the
single-device layout: the port's counterpart of ``np.asarray`` on a
sharded ``jax.Array``.

A carry in the replicated-spectral layout (``parallel.shard_model_state``
of a model built without a mesh) holds DTensors: ``carry_to_layout``
places a global numpy carry so, and ``carry_to_global`` gathers each
DTensor's global tensor (its ``full_tensor()``).

The LW k-table calibration's parameter vector and tables dict carry
over with ``lw_params_to_torch``, as leaf tensors that may require grad.

Nothing else carries over: a model built with ``fft_impl='matmul'``
rebuilds its DFT matrices from nlon and the truncation, and CORK
radiation has no parameters beyond its k-table, a numpy dict that
``components.cork.ck_tables.load_k_table`` takes in both packages.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .ops.sht import complex_dtype
from .parallel.mesh import gather_global, shard_model_state


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


def carry_to_rank(carry_np, sht, device, dtype):
    """A global carry of numpy arrays -> this rank's carry under the mesh
    of ``sht`` (a ``parallel.DistributedSHT``): complex (spectral) arrays
    padded to M_padded where they are not, and cut to the rank's m-block;
    real (grid) arrays cut to its latitude rows; a step index an int."""
    def local(x):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            if x.shape[-2] == sht.truncation + 1:
                x = sht.pad_spec(x)
            return x[..., sht.m_rows, :]
        return x[..., sht.rows, :]

    return carry_from_numpy(tuple(
        {name: local(v) for name, v in part.items()}
        if isinstance(part, dict) else part for part in carry_np),
        device, dtype)


def carry_to_layout(carry_np, mesh, device, dtype, shard_lon=False):
    """A global carry of numpy arrays -> this rank's carry in the
    replicated-spectral layout of ``mesh``, as ``shard_model_state``
    places a model's own carry (spectral fields whole, grid fields cut
    into the rank's block, DTensors)."""
    return shard_model_state(mesh, *carry_from_numpy(carry_np, device, dtype),
                             shard_lon=shard_lon)


def carry_to_global(carry, sht=None):
    """The ranks' carries -> the global carry of numpy arrays, in the
    single-device layout (M unpadded), on every rank: each spectral field
    gathered over the 'lat' group by m-block, each grid field by rows, or
    for a DTensor carry (``sht`` not needed) each tensor's global value
    (``parallel.mesh.gather_global``). Every rank of the group must call
    it. Dicts of diagnostics pass as one-element tuples."""
    def glob(v):
        if isinstance(v, DTensor):
            v = gather_global(v)
        else:
            v = sht.gather_m(v) if v.is_complex() else sht.gather_rows(v)
        return v.detach().cpu().numpy()

    return tuple({name: glob(v) for name, v in part.items()}
                 if isinstance(part, dict) else np.int32(part)
                 for part in carry)


def lw_params_to_torch(theta, tables=None, device='cpu', dtype=torch.float64,
                       requires_grad=False):
    """The LW k-table calibration's state of the JAX package -> tensors:
    theta (805,) and, when given, its tables dict {name: array} (numpy,
    or JAX arrays fetched with ``np.asarray``), each a leaf tensor of
    ``dtype`` on ``device`` with ``requires_grad`` as asked.  Returns
    (theta, tables or None)."""
    def leaf(x):
        return torch.as_tensor(np.array(x), dtype=dtype,
                               device=device).requires_grad_(requires_grad)

    return leaf(theta), (None if tables is None else
                         {name: leaf(v) for name, v in tables.items()})
