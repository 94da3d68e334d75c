"""Device mesh and sharding layouts (climt_tpu/parallel/mesh.py).

The scaling dimension is the horizontal grid: every physics component is
parallel over columns, and the dycore couples columns only through the
spectral transforms.  Two decompositions shard grid fields (nz, nlat,
nlon) over latitude bands on the mesh's 'lat' axis:

- the m-sharded one (``build_moist_gcm(mesh=...)``): the spectral state
  sharded over zonal wavenumber m (``DistributedSHT``), a 'lon' extent
  above 1 repeating each latitude block on every 'lon' rank;
- the replicated-spectral one of ``shard_model_state``: a model built
  without a mesh, its spectral state whole on every rank and its grid
  fields cut into latitude blocks, or latitude x longitude blocks with
  ``shard_lon=True`` (``ReplicatedSHT``).

Where JAX places global arrays on a mesh and lets its partitioner split
the work, each rank of the port holds its own block as an ordinary
tensor, and the collectives are explicit ``torch.distributed`` calls on
the mesh's process groups.  ``grid_sharding`` and ``replicated`` give the
layouts as DTensor placements, one per mesh axis.  ``shard_model_state``
wraps each rank's blocks as DTensors of those placements, so that
``full_tensor()`` gives the global field as ``np.asarray`` does for a
sharded ``jax.Array``; the models unwrap them to step the blocks and
never let DTensor dispatch their operations.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .distributed import TIMEOUT
from .rep_sht import all_gather_cat


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
    nlon): latitude sharded over 'lat'; longitude sharded over 'lon' with
    ``shard_lon``, else repeated on every 'lon' rank."""
    axes = {'lat': Shard(ndim - 2),
            'lon': Shard(ndim - 1) if shard_lon else Replicate()}
    return tuple(axes.get(name, Replicate()) for name in mesh.mesh_dim_names)


def replicated(mesh):
    """DTensor placements of a field every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def _placements(mesh, x, shard_lon):
    """The placements of a carry tensor in the replicated-spectral layout:
    real fields of two or more dimensions are grid fields, every other
    tensor (the complex spectral fields) is replicated."""
    if x.is_complex() or x.ndim < 2:
        return replicated(mesh)
    return grid_sharding(mesh, x.ndim, shard_lon)


def block_of(mesh, x, shard_lon=False):
    """This rank's block of a global field x in the replicated-spectral
    layout (the whole of a replicated one)."""
    out = x
    for axis, p in zip(mesh.mesh_dim_names, _placements(mesh, x, shard_lon)):
        if isinstance(p, Shard):
            n = mesh.shape[mesh.mesh_dim_names.index(axis)]
            if x.shape[p.dim] % n:
                raise ValueError('dim %d of %s is not divisible by %d %r '
                                 'ranks' % (p.dim, tuple(x.shape), n, axis))
            out = out.tensor_split(n, dim=p.dim)[mesh.get_local_rank(axis)]
    return out.contiguous()


def wrap_carry(mesh, carry, shard_lon=False):
    """A carry of rank-local blocks (dicts of tensors, step indices) as
    DTensors of the replicated-spectral layout; communicates nothing."""
    def wrap(x):
        return DTensor.from_local(x, mesh, _placements(mesh, x, shard_lon),
                                  run_check=False)

    return tuple({k: wrap(v) for k, v in part.items()}
                 if isinstance(part, dict) else part for part in carry)


def carry_layout(carry):
    """(mesh, shard_lon) of a carry placed by ``shard_model_state``, or
    None for a carry of plain tensors."""
    for part in carry:
        for v in (part.values() if isinstance(part, dict) else ()):
            if isinstance(v, DTensor) and not v.is_complex() and v.ndim >= 2:
                mesh = v.device_mesh
                lon = v.placements[mesh.mesh_dim_names.index('lon')]
                return mesh, isinstance(lon, Shard)
    return None


def gather_global(x):
    """The global tensor of a DTensor of these layouts, on every rank:
    ``full_tensor()``, written as list ``all_gather``s over each sharded
    mesh axis (the collectives gloo also takes with CUDA tensors)."""
    out = x.to_local()
    mesh = x.device_mesh
    for axis, p in zip(mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            out = all_gather_cat(out, mesh.get_group(axis), mesh.shape[
                mesh.mesh_dim_names.index(axis)], p.dim)
    return out


def unwrap_carry(carry):
    """The rank-local blocks of a DTensor carry (``to_local``)."""
    return tuple({k: v.to_local() if isinstance(v, DTensor) else v
                  for k, v in part.items()} if isinstance(part, dict)
                 else part for part in carry)


def shard_model_state(mesh, prev, now, grids, aux=None, step_idx=None,
                      shard_lon=False):
    """Place a model carry built without a mesh onto ``mesh`` in the
    replicated-spectral layout (mesh.py:57): the spectral states whole on
    every rank, the grid and aux fields of two or more dimensions cut into
    latitude blocks (latitude x longitude blocks with ``shard_lon``), the
    others whole, the step index a Python int.  Every tensor comes back as
    a DTensor wrapping the rank's block (``DTensor.from_local``, no
    communication); the model's own ``step_fn``/``run_fn`` step such a
    carry on the blocks.  In the grid moisture modes the states' real
    'q' is a grid field and is cut like one (JAX replicates it; the values
    are the same).  Every rank passes the same global carry."""
    def place(part):
        return {k: block_of(mesh, v, shard_lon) for k, v in part.items()}

    out = (place(prev), place(now), place(grids))
    if aux is not None:
        out = out + (place(aux),)
    if step_idx is not None:
        out = out + (int(step_idx),)
    return wrap_carry(mesh, out, shard_lon)
