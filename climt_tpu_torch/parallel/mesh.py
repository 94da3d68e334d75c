"""Device mesh and sharding layouts (climt_tpu/parallel/mesh.py).

The scaling dimension is the horizontal grid: every physics component is
parallel over columns, and the dycore couples columns only through the
spectral transforms.  The production decomposition shards grid fields
(nz, nlat, nlon) over latitude bands on the mesh's 'lat' axis and the
spectral state over zonal wavenumber m (``DistributedSHT``); a 'lon'
extent above 1 repeats each latitude block on every 'lon' rank.

Where JAX places global arrays on a mesh and lets its partitioner split
the work, each rank of the port holds its own block as an ordinary
tensor, and the collectives are explicit ``torch.distributed`` calls on
the mesh's 'lat' process group.  ``grid_sharding`` and ``replicated`` give
the layouts as DTensor placements, one per mesh axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .distributed import TIMEOUT

_NEXT = ('the longitude decomposition and the replicated-spectral layout '
         'are ROADMAP.md queue 1 item 4b')


def default_mesh_shape(n):
    """(lat, lon) extents of an n-device mesh, the JAX rule: latitude
    first (the FFT axis stays local), a lon factor of 2 where n is even
    and above 2."""
    lon_factor = 2 if n % 2 == 0 and n > 2 else 1
    return n // lon_factor, lon_factor


def make_mesh(n_devices=None, mesh_shape=None, axis_names=('lat', 'lon'),
              device='cuda'):
    """A 2-D ``DeviceMesh`` over every rank of the default process group
    (``initialize_distributed`` first), rank r at mesh position r in
    row-major order.  ``n_devices``, when given, must be the world size:
    each rank drives one device.  Each axis's process groups get the
    start-up's ``TIMEOUT``, as the default group does."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call '
                           'climt_tpu_torch.parallel.initialize_distributed '
                           'first')
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError('n_devices=%d: the mesh spans all %d ranks, one '
                         'device each' % (n, world))
    shape = default_mesh_shape(n) if mesh_shape is None else tuple(
        mesh_shape)
    grid = torch.arange(world).reshape(shape)
    groups = []
    for dim, size in enumerate(shape):
        # the ranks along this axis, every other index fixed; every rank
        # creates every group, in the same order
        lines = grid.movedim(dim, -1).reshape(-1, size).tolist()
        group, _ = dist.new_subgroups_by_enumeration(lines, timeout=TIMEOUT)
        groups.append(group)
    return DeviceMesh.from_group(groups, torch.device(device).type,
                                 mesh=grid, mesh_dim_names=tuple(axis_names))


def grid_sharding(mesh, ndim=3, shard_lon=False):
    """DTensor placements of a grid field, (nz, nlat, nlon) or (nlat,
    nlon): latitude sharded over 'lat', repeated over 'lon'."""
    if shard_lon:
        raise NotImplementedError('shard_lon=True: ' + _NEXT)
    lat_dim = 1 if ndim == 3 else 0
    return tuple(Shard(lat_dim) if name == 'lat' else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh):
    """DTensor placements of a field every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def shard_model_state(mesh, prev, now, grids, aux=None, step_idx=None,
                      shard_lon=False):
    """JAX's replicated-spectral placement of a model built without a
    mesh; not ported yet: build the model with ``mesh=`` and carry its
    rank-local state (``convert.carry_to_rank``) instead."""
    raise NotImplementedError('shard_model_state: ' + _NEXT)
