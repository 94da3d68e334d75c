"""Floating-point operations one step of the moist GCM with
semi-Lagrangian moisture needs (``moisture_advection='sl'``): the
numerator of ``mfu.gcm`` in the SL cell.

q stays a grid field, so the dycore makes the transforms of the FV mode
(``gcm.TRANSFORMS['fv']``: no synthesis, gradient or analysis of q);
the water fixer, on in this mode, adds two syntheses of one level, the
surface pressure of the previous and of the new state, and nothing for
q.  Every other term is ``gcm``'s: the Legendre products, the zonal
FFTs, the implicit solve, the column physics and the radiation.  Not
counted, as FV's are not: the SL transport's own arithmetic (departure
points, the bilinear gathers, the vertical pass) and the fixer's sums.
"""

from __future__ import annotations

import math

from . import gcm, rrtmg

# the water fixer's one-level syntheses a step
FIXER_SYNTHESES = 2


def dynamics_flops(nlon, nlat, nz):
    """Counted operations of one step's dynamics in the SL mode."""
    m = gcm.truncation(nlon, nlat)
    pairs = (m + 1) * (m + 2) // 2
    synthesis = 4 * pairs * nlat + 2.5 * nlon * math.log2(nlon) * nlat
    return (gcm.dynamics_flops(nlon, nlat, nz, 'fv')
            + FIXER_SYNTHESES * synthesis)


def cycle_flops(nlon, nlat, nz, rad_every):
    """Counted operations of one radiation cycle: ``rad_every`` steps, the
    first of which radiates every column."""
    step = dynamics_flops(nlon, nlat, nz) + gcm.physics_flops(
        nlon, nlat, nz)
    return rad_every * step + rrtmg.call_flops(nz, nlon * nlat)
