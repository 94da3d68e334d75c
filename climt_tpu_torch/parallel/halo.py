"""One-row latitude halo exchange (climt_tpu/parallel/halo.py).

The FV transport's meridional pass (ops/fv_advection.py) needs each
latitude row's northern and southern neighbour.  On a latitude-sharded
mesh a block's first and last rows have theirs on the adjacent 'lat'
ranks: this module exchanges exactly that boundary row with
``batch_isend_irecv`` and zero-fills the global pole rows (the poles are
closed faces, so the zero is the physical boundary condition, as in the
single-device shifts).

``make_lat_halo(mesh)`` returns a callable with the
``FVAdvection(halo_exchange=...)`` contract: ``halo(x, +1)`` gives row j
the value of row j-1 (its northern neighbour), ``halo(x, -1)`` the value
of row j+1, for fields (..., nlat/L, nlon) with latitude on dim -2.  It
also carries the rank's 'lat' index and extent and the process group,
from which ``FVAdvection`` cuts its rows and all-reduces its mass.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class LatHalo:
    """halo(x, shift) on one rank's latitude block; counts its calls in
    ``LatHalo.calls`` and the bytes it sends in ``LatHalo.bytes``."""

    calls = 0
    bytes = 0

    def __init__(self, mesh, axis='lat'):
        self.group = mesh.get_group(axis)
        self.size = mesh.shape[mesh.mesh_dim_names.index(axis)]
        self.index = mesh.get_local_rank(axis)
        ranks = dist.get_process_group_ranks(self.group)
        # global ranks of the blocks to the north (index - 1) and south
        self.north = ranks[self.index - 1] if self.index > 0 else None
        self.south = (ranks[self.index + 1] if self.index < self.size - 1
                      else None)

    def __call__(self, x, shift):
        LatHalo.calls += 1
        if shift == +1:       # row j <- row j-1: last rows travel south
            send, to, frm = x[..., -1:, :], self.south, self.north
        elif shift == -1:     # row j <- row j+1: first rows travel north
            send, to, frm = x[..., :1, :], self.north, self.south
        else:
            raise ValueError('shift %r: expected +1 or -1' % (shift,))
        send = send.contiguous()
        recv = torch.zeros_like(send)
        ops = []
        if to is not None:
            ops.append(dist.P2POp(dist.isend, send, to, self.group))
            LatHalo.bytes += send.numel() * send.element_size()
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, recv, frm, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if shift == +1:
            return torch.cat([recv, x[..., :-1, :]], dim=-2)
        return torch.cat([x[..., 1:, :], recv], dim=-2)


def make_lat_halo(mesh, axis='lat'):
    """halo(x, shift) for latitude-sharded (..., nlat/L, nlon) fields."""
    return LatHalo(mesh, axis)
