"""McICA stochastic cloud subcolumns for RRTMG LW and SW
(climt_tpu/components/rrtmg/mcica.py).

One uniform deviate per (layer, column, g-point), drawn per the overlap
assumption: 1 random (independent), 2 maximum-random (a layer keeps the
deviate of the layer below while that one is cloudy, else rescales its
own), 3 maximum (one deviate per column and g-point).  A subcolumn is
cloudy where its deviate reaches 1 - cloud fraction; cloudy subcolumns
carry the grid-mean water paths and the band's direct-input optical
depth, clear ones zero.

The deviates come from a ``torch.Generator`` that the components seed per
call from numpy's global RNG, the JAX package's protocol with its PRNG
key.  JAX draws with threefry, so the two packages' subcolumns agree in
distribution, not draw for draw; ``subcolumns_from_deviates`` takes the
deviates as an argument so that everything after the draw can be held
against JAX exactly.
"""

from __future__ import annotations

import torch

CLDMIN = 1.0e-6


def subcolumns_from_deviates(raw, overlap, cldfrac, ciwp, clwp, tauc_band,
                             ngb):
    """Subcolumns from uniform deviates ``raw``: (nz, ncol, ngpt) for
    overlap 1 and 2, (1, ncol, ngpt) for overlap 3.  cldfrac/ciwp/clwp
    (nz, ncol) bottom-up, tauc_band (nz, ncol, nband), ngb (ngpt,) the
    band of each g-point.  Returns (cldfmc, ciwpmc, clwpmc, taucmc), each
    (nz, ncol, ngpt) (mcica.py:38)."""
    cldf = torch.where(cldfrac < CLDMIN, 0.0, cldfrac)
    if overlap == 1:
        cdf = raw
    elif overlap == 2:
        levels = [raw[0]]
        for z in range(1, raw.shape[0]):
            clear_below = (1.0 - cldf[z - 1])[:, None]
            levels.append(torch.where(levels[-1] > clear_below, levels[-1],
                                      raw[z] * clear_below))
        cdf = torch.stack(levels)
    elif overlap == 3:
        cdf = raw.expand((cldfrac.shape[0],) + tuple(raw.shape[1:]))
    else:
        raise ValueError('unsupported overlap %r' % (overlap,))
    iscloudy = cdf >= (1.0 - cldf)[..., None]
    ngb = torch.as_tensor(ngb, dtype=torch.int64, device=cldfrac.device)
    return (iscloudy.to(cldfrac.dtype),
            torch.where(iscloudy, ciwp[..., None], 0.0),
            torch.where(iscloudy, clwp[..., None], 0.0),
            torch.where(iscloudy, tauc_band[..., ngb], 0.0))


def mcica_subcolumns(generator, overlap, cldfrac, ciwp, clwp, tauc_band,
                     ngb):
    """Draw the deviates from ``generator`` (a torch.Generator on the
    fields' device) and build the subcolumns, as
    ``subcolumns_from_deviates``.  JAX takes a PRNG key in this place;
    anything but a ``torch.Generator`` raises ``TypeError``."""
    if not isinstance(generator, torch.Generator):
        raise TypeError('mcica_subcolumns: the first argument must be a '
                        'torch.Generator (the JAX package takes a PRNG key '
                        'there), got %s' % type(generator).__name__)
    nz, ncol = cldfrac.shape
    shape = (1 if overlap == 3 else nz, ncol, len(ngb))
    raw = torch.rand(shape, generator=generator, dtype=cldfrac.dtype,
                     device=cldfrac.device)
    return subcolumns_from_deviates(raw, overlap, cldfrac, ciwp, clwp,
                                    tauc_band, ngb)
