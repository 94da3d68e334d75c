"""Fused LW flux integration (rtrn): kernel A and its plain version.

TPU kernel replaced: climt_tpu/components/rrtmg/pallas_rtrn.py:195
(``rtrn_lw_fused``, Pallas body ``_rtrn_kernel`` :73).  Both versions
here compute what ``lw_spectral.rtrn_lw``'s XLA path computes
(lw_spectral.py:787-906) for the GCM's configuration: analytic
transmittance, band-level clouds, no dF/dTs.

Bound on the card: by bytes, ~0.09 ms at nz=28, ncol=8192 (taug and
fracs, 8 bytes per (g, layer, column), read once, the band rows and the
outputs); in practice the two sweeps' arithmetic, which a thread per
(g, column) issues for every layer, takes most of the time (PERF.md).
``csrc/rtrn_lw.cu`` gives a block one column, brings the column's taug,
fracs and band rows into shared memory once with ``cp.async``, computes
the band cloud prologue (odcl, exp(-odcl), the cloudy
(1 - exp(-odcl)) * cldfrac) there, and runs both sweeps from shared
memory with the z recurrences in registers.  The g-sums are warp
reduce-scatters of 8 interfaces at a time written as per-warp partials,
added in warp order after the one block barrier, so they are the same
from run to run.  The up sweep recomputes its layer terms from the tile.

The gas small-od test is ``od <= 0.06`` and the total one
``odtot < 0.06`` (pallas_rtrn.py:102, :114), as in the reference.  The
source factor uses the table's rec_6 = 0.166667 like the XLA path; the
Pallas body divides by 6 (a 2e-6 relative difference in that branch).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build

# the LW band layout (lw_spectral.py:59-64), one definition for the
# kernel and for lw_spectral, which exports it: g-points per band (ngc of
# rrtmg_lw_init.f90), each band's first g-point, each g-point's 0-based
# band
NBANDS = 16
NGPT = 140
NG = [10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2]
NGS = np.concatenate([[0], np.cumsum(NG)])
NGB = np.concatenate([np.full(n, b) for b, n in enumerate(NG)])

MAX_SMEM_BYTES = 232448     # shared memory one block may use on Hopper
WARPS = 5                   # warps of one block of kernel A


def smem_bytes(nz):
    """Dynamic shared memory of one block of kernel A (csrc/rtrn_lw.cu):
    the column's taug, fracs, band rows and cloud terms, and the warp
    partial sums."""
    tile = 2 * nz * NGPT + (5 * nz + 1) * NBANDS + (nz + 3) // 4 * 4
    return 4 * (tile + WARPS * (nz + 1) * 4)


def _ngb(device):
    return torch.as_tensor(NGB, dtype=torch.int64, device=device)


def _absorptance_and_source(od, small, rec_6):
    """Layer absorptance and linear-in-tau source factor with analytic
    transmittance, Taylor forms where ``small`` (lw_spectral.py:712-723,
    :808-819)."""
    od_safe = torch.clamp(od, min=1.0e-12)
    expo = torch.exp(-od_safe)
    tfn = 1.0 - 2.0 * (1.0 / od_safe - expo / (1.0 - expo))
    return (torch.where(small, od - 0.5 * od * od, 1.0 - expo),
            torch.where(small, rec_6 * od, tfn))


def lw_sweeps(atrans, atot, bbdgas, bbugas, bbdtot, bbutot, efclfrac,
              cldf, cloudy, rad0, reflect):
    """The two sweeps of the random-overlap transfer, all-sky and clear
    (lw_spectral.py:832-887), Python loops over z.  Layer terms (nz, ncol,
    g); rad0 the surface source and reflect 1 - emissivity, (ncol, g).
    Returns the radiance lists (urad, drad, curad, cdrad) on the nz + 1
    interfaces, surface first; ``lw_spectral``'s general sweep shares it.
    """
    nz = atrans.shape[0]
    gassrc_dn = bbdgas * atrans
    gassrc_up = bbugas * atrans
    zero = torch.zeros_like(rad0)
    drad = [None] * (nz + 1)
    cdrad = [None] * (nz + 1)
    drad[nz] = zero
    cdrad[nz] = zero
    rad, radc = zero, zero
    for z in range(nz - 1, -1, -1):
        rad_cloudy = (rad - rad * (atrans[z] + efclfrac[z]
                                   * (1.0 - atrans[z]))
                      + gassrc_dn[z] + cldf[z] * (bbdtot[z] * atot[z]
                                                  - gassrc_dn[z]))
        rad_clear = rad + (bbdgas[z] - rad) * atrans[z]
        rad = torch.where(cloudy[z], rad_cloudy, rad_clear)
        radc = radc + (bbdgas[z] - radc) * atrans[z]
        drad[z] = rad
        cdrad[z] = radc

    # surface source + reflection (rtrn.f90:460-476)
    radu = rad0 + reflect * rad
    raduc = rad0 + reflect * radc
    urad = [radu]
    curad = [raduc]
    for z in range(nz):
        rad_cloudy = (radu - radu * (atrans[z] + efclfrac[z]
                                     * (1.0 - atrans[z]))
                      + gassrc_up[z] + cldf[z] * (bbutot[z] * atot[z]
                                                  - gassrc_up[z]))
        rad_clear = radu + (bbugas[z] - radu) * atrans[z]
        radu = torch.where(cloudy[z], rad_cloudy, rad_clear)
        raduc = raduc + (bbugas[z] - raduc) * atrans[z]
        urad.append(radu)
        curad.append(raduc)
    return urad, drad, curad, cdrad


def rtrn_lw_plain(taug, fracs, planklay, planklev, plankbnd, semiss,
                  secdiff, cldfrac, taucld_band, dwave_g, rec_6):
    """Plain PyTorch version: the XLA path of rtrn_lw, lw_spectral.py:
    787-906, with Python loops over z.  Layout (nz, ncol, 140) throughout.

    Returns (totuflux, totdflux, totuclfl, totdclfl), each (nz+1, ncol).
    """
    nz, ncol, _ = taug.shape
    ngb = _ngb(taug.device)
    sec_g = secdiff.T[:, ngb]                          # (ncol, 140)
    odepth = torch.clamp(sec_g * taug, min=0.0)        # (nz, ncol, 140)
    blay = planklay[..., ngb]
    bup = planklev[1:][..., ngb] - blay
    bdn = planklev[:-1][..., ngb] - blay

    odcld = (taucld_band * secdiff.T)[..., ngb]
    cldf = cldfrac[..., None].expand_as(odcld)
    cloudy = cldf >= 1.0e-6
    odcld = torch.where(cloudy, odcld, 0.0)

    odtot = odepth + odcld
    atrans, tfacgas = _absorptance_and_source(odepth, odepth <= 0.06, rec_6)
    atot, tfactot = _absorptance_and_source(odtot, odtot < 0.06, rec_6)

    efclfrac = torch.where(cloudy, (1.0 - torch.exp(-odcld)) * cldf, 0.0)
    urad, drad, curad, cdrad = lw_sweeps(
        atrans, atot, fracs * (blay + tfacgas * bdn),
        fracs * (blay + tfacgas * bup), fracs * (blay + tfactot * bdn),
        fracs * (blay + tfactot * bup), efclfrac, cldf, cloudy,
        fracs[0] * plankbnd[:, ngb], 1.0 - semiss.T[:, ngb])

    def to_flux(levels):
        return torch.einsum('lcg,g->lc', torch.stack(levels), dwave_g)

    return to_flux(urad), to_flux(drad), to_flux(curad), to_flux(cdrad)


def rtrn_lw_cuda(taug, fracs, planklay, planklev, plankbnd, semiss,
                 secdiff, cldfrac, taucld_band, dwave_g, rec_6):
    """Launch kernel A.  Shapes as ``rtrn_lw_plain``; float32, contiguous,
    on one CUDA device."""
    args = (taug, fracs, planklay, planklev, plankbnd, semiss, secdiff,
            cldfrac, taucld_band, dwave_g)
    dev = taug.device
    if not all(a.is_cuda and a.device == dev for a in args):
        raise ValueError('rtrn_lw_cuda: all tensors must be on one CUDA '
                         'device')
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError('rtrn_lw_cuda takes float32 tensors')
    if not all(a.is_contiguous() for a in args):
        raise ValueError('rtrn_lw_cuda takes contiguous tensors')
    nz, ncol = taug.shape[:2]
    expected = {
        'taug': (nz, ncol, NGPT), 'fracs': (nz, ncol, NGPT),
        'planklay': (nz, ncol, NBANDS), 'planklev': (nz + 1, ncol, NBANDS),
        'plankbnd': (ncol, NBANDS), 'semiss': (NBANDS, ncol),
        'secdiff': (NBANDS, ncol), 'cldfrac': (nz, ncol),
        'taucld_band': (nz, ncol, NBANDS), 'dwave_g': (NGPT,)}
    for name, a in zip(expected, args):
        if tuple(a.shape) != expected[name]:
            raise ValueError('rtrn_lw_cuda: %s has shape %s, expected %s'
                             % (name, tuple(a.shape), expected[name]))
    if smem_bytes(nz) > MAX_SMEM_BYTES:
        raise ValueError('rtrn_lw_cuda: nz=%d needs %d bytes of shared '
                         'memory per block, more than %d' % (
                             nz, smem_bytes(nz), MAX_SMEM_BYTES))

    outs = [torch.empty((nz + 1, ncol), dtype=torch.float32, device=dev)
            for _ in range(4)]
    lib = _build.library()
    rc = lib.climt_rtrn_lw_f32(
        *[a.data_ptr() for a in args], nz, ncol, float(rec_6),
        *[o.data_ptr() for o in outs],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, 'rtrn_lw_cuda')
    rtrn_lw_cuda.launches += 1
    return tuple(outs)


rtrn_lw_cuda.launches = 0


def rtrn_lw_fused(taug, fracs, planklay, planklev, plankbnd, semiss,
                  secdiff, cldfrac, taucld_band, dwave_g, rec_6):
    """Flux integration: the plain version for CPU tensors (autograd
    follows it), kernel A for CUDA tensors (float32).  Returns (totuflux,
    totdflux, totuclfl, totdclfl), (nz+1, ncol) each, quadrature-weighted
    by dwave_g.  Kernel A has no backward, as the JAX package's Pallas
    kernel has none: on the card, with grad mode on, an input that
    requires grad raises rather than give a result without a gradient."""
    args = (taug, fracs, planklay, planklev, plankbnd, semiss, secdiff,
            cldfrac, taucld_band, dwave_g)
    if taug.device.type == 'cpu':
        return rtrn_lw_plain(*args, rec_6)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError(
            'kernel A (rtrn_lw_cuda) has no backward: a float32 LW call on '
            'the card with inputs that require grad cannot be '
            'differentiated; run it in float64 (the general sweep) or on '
            'the CPU')
    return rtrn_lw_cuda(*[a.contiguous() for a in args], rec_6)
