"""Floating-point operations one step of the moist GCM needs, from the
configuration's shapes: the numerator of ``mfu.*``.

Counted, per step:
- each Legendre synthesis and analysis as the product it is: 4
  operations (a multiply-add on the real and on the imaginary part) per
  retained (m, n >= m) pair, latitude and level;
- each zonal FFT at 2.5 n log2 n per real row of n longitudes;
- the four level-coupling products of the semi-implicit solve (G, M,
  the per-n inverse, tau) at 4 nz^2 per (m, n) pair;
- the column physics per (column, level): 40 for simple physics and 100
  for Emanuel's elementwise work, plus Emanuel's two (nz^2 x nz)
  products per column exactly (2 nz^3 each);
- on a radiation step, the LW+SW call of every column
  (``costs.rrtmg.call_flops``).
Not counted: the grid-point arithmetic of the dynamics, the FV
transport, the water fixer's sums, the gas optics and the optics set-up
of the radiation.

The transform counts are those of the algorithm for each moisture mode:
with spectral moisture a step makes 14 syntheses of nz levels and 5 of
one level, 8 analyses of nz levels and 1 of one level, and 6 forward
FFTs of nz levels and 1 of one level (the dynamics stage and the water
fixer); with FV moisture 9 and 4 syntheses, 6 and 1 analyses, 4 and 1
forward FFTs, and no fixer.  Every synthesis ends in one inverse FFT.
"""

from __future__ import annotations

import math

from . import rrtmg

TRANSFORMS = {
    # (syntheses nz, syntheses 1, analyses nz, analyses 1, rfft nz, rfft 1)
    'spectral': (14, 5, 8, 1, 6, 1),
    'fv': (9, 4, 6, 1, 4, 1),
}
SIMPLE_PHYSICS_OPS = 40
EMANUEL_OPS = 100


def truncation(nlon, nlat):
    return min((2 * nlat - 1) // 3, (nlon - 1) // 3)


def dynamics_flops(nlon, nlat, nz, moisture):
    """Counted operations of one step's dynamics (transforms and the
    semi-implicit products)."""
    m = truncation(nlon, nlat)
    pairs = (m + 1) * (m + 2) // 2
    syn_n, syn_1, ana_n, ana_1, fft_n, fft_1 = TRANSFORMS[moisture]
    legendre = 4 * pairs * nlat * (
        (syn_n + ana_n) * nz + (syn_1 + ana_1))
    row = 2.5 * nlon * math.log2(nlon)
    ffts = row * nlat * ((syn_n + fft_n) * nz + (syn_1 + fft_1))
    implicit = 4 * 4 * nz * nz * pairs
    return legendre + ffts + implicit


def physics_flops(nlon, nlat, nz):
    ncol = nlon * nlat
    return ncol * ((SIMPLE_PHYSICS_OPS + EMANUEL_OPS) * nz
                   + 2 * 2 * nz ** 3)


def cycle_flops(nlon, nlat, nz, rad_every, moisture):
    """Counted operations of one radiation cycle: ``rad_every`` steps, the
    first of which radiates every column."""
    step = dynamics_flops(nlon, nlat, nz, moisture) + physics_flops(
        nlon, nlat, nz)
    return rad_every * step + rrtmg.call_flops(nz, nlon * nlat)
