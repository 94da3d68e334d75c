"""The moist GCM of the plain reference with semi-Lagrangian moisture.

``gcm.MoistGCM`` with its water vapour a grid field moved by
``sl.SLAdvection`` (the dycore's grid-moisture branch, as for FV
moisture: transported from t - dt over 2 dt on the centre winds and
mass fluxes, no hyperdiffusion on q) and the global water fixer kept
on, acting on grid q.  A carry has the program's layout for
``build_moist_gcm(moisture_advection='sl')``.
"""

from __future__ import annotations

import torch

from . import gcm
from .sl import SLAdvection


class MoistGCM(gcm.MoistGCM):
    """One-device moist GCM with SL moisture: ``init(seed)``,
    ``step(carry)`` as ``gcm.MoistGCM``'s."""

    def __init__(self, nlon, nlat, nz, timestep, moisture_advection='sl',
                 dtype=torch.float32, device='cuda', **kw):
        if moisture_advection != 'sl':
            raise ValueError('moisture_advection %r: this model moves '
                             'moisture semi-Lagrangianly' % (
                                 moisture_advection,))
        # built as the spectral-moisture model (its fixer on), then its
        # dycore given the grid transport
        super().__init__(nlon, nlat, nz, timestep, dtype=dtype,
                         device=device, moisture_advection='spectral', **kw)
        dycore = self.dycore
        dycore.fv = SLAdvection(dycore.sht.mu, nlon, dycore.radius,
                                dtype=dtype, device=device)
        dycore.moisture_advection = 'sl'

    def _fix_water(self, new, prev, phys):
        """Global multiplicative water fixer on grid q: the new state's
        clipped q scaled so that its total sum(w q dp) is the previous
        state's plus 2 dt times the physics' source."""
        dycore = self.dycore
        dp_prev = dycore._dp_of(prev['lnps'])
        dp_new = dycore._dp_of(new['lnps'])
        q_pos = torch.clamp(new['q'], min=0.0)
        src = torch.sum(self.wlat * phys['dq'] * dp_prev)
        tw_prev = torch.sum(self.wlat * prev['q'] * dp_prev)
        tw_new = torch.sum(self.wlat * q_pos * dp_new)
        target = tw_prev + 2.0 * self.dt * src
        scale = torch.where(tw_new > 0.0,
                            torch.clamp(target, min=0.0) / tw_new, 1.0)
        return dict(new, q=q_pos * scale)
